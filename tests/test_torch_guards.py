"""Guards of the PyTorch port's package rules: it imports neither ``jax``
nor the JAX package (nor does a replica worker process), its entry points
run on the card by default and raise when there is none, and
``chip_smoke.py`` fails (printing no result) where there is no card or no
port beside it."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import paddle_tpu_torch
from paddle_tpu_torch import ops
from paddle_tpu_torch.inference.serving import (_UNPORTED_DEFAULTS,
                                                GenerationServer)
from paddle_tpu_torch.inference.speculative import SpecConfig
from paddle_tpu_torch.models.llama import LlamaForCausalLM, llama_tiny_config
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.parallel import ParallelEngine

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "paddle_tpu_torch"
PORT_MODULES = ["paddle_tpu_torch", "paddle_tpu_torch.amp",
                "paddle_tpu_torch.autotune",
                "paddle_tpu_torch.autotune.workload",
                "paddle_tpu_torch.autotune.space",
                "paddle_tpu_torch.autotune.cost",
                "paddle_tpu_torch.autotune.features",
                "paddle_tpu_torch.autotune.profile",
                "paddle_tpu_torch.autotune.search",
                "paddle_tpu_torch.autotune.kernel_geometry",
                "paddle_tpu_torch.cost_model",
                "paddle_tpu_torch.fleetsim", "paddle_tpu_torch.fleetsim.clock",
                "paddle_tpu_torch.fleetsim.sim",
                "paddle_tpu_torch.fleetsim.traffic",
                "paddle_tpu_torch.inference.autoscale",
                "paddle_tpu_torch.inference.fleet",
                "paddle_tpu_torch.inference.replica_worker",
                "paddle_tpu_torch.inference.transport",
                "paddle_tpu_torch.compat", "paddle_tpu_torch.device",
                "paddle_tpu_torch.linalg",
                "paddle_tpu_torch.regularizer",
                "paddle_tpu_torch.distributed",
                "paddle_tpu_torch.distributed.fleet",
                "paddle_tpu_torch.distributed.fleet.recompute",
                "paddle_tpu_torch.faults",
                "paddle_tpu_torch.graphs",
                "paddle_tpu_torch.telemetry",
                "paddle_tpu_torch.ops",
                "paddle_tpu_torch.ops._build",
                "paddle_tpu_torch.ops.decode_megakernel",
                "paddle_tpu_torch.ops.decode_megakernel_cuda",
                "paddle_tpu_torch.ops.flash_attention",
                "paddle_tpu_torch.ops.flash_attention_cuda",
                "paddle_tpu_torch.ops.fused_adamw",
                "paddle_tpu_torch.ops.fused_ce",
                "paddle_tpu_torch.ops.fused_lora_cuda",
                "paddle_tpu_torch.ops.fused_norm",
                "paddle_tpu_torch.ops.int8",
                "paddle_tpu_torch.ops.int8_cuda",
                "paddle_tpu_torch.ops.paged_attention",
                "paddle_tpu_torch.ops.paged_attention_cuda",
                "paddle_tpu_torch.ops.stream_matmul",
                "paddle_tpu_torch.ops.stream_matmul_cuda",
                "paddle_tpu_torch.incubate", "paddle_tpu_torch.incubate.nn",
                "paddle_tpu_torch.incubate.nn.functional",
                "paddle_tpu_torch.models", "paddle_tpu_torch.models.ernie",
                "paddle_tpu_torch.models.gpt",
                "paddle_tpu_torch.models.llama",
                "paddle_tpu_torch.models.convert",
                "paddle_tpu_torch.models.generation",
                "paddle_tpu_torch.inference",
                "paddle_tpu_torch.inference.lora",
                "paddle_tpu_torch.inference.kv_offload",
                "paddle_tpu_torch.inference.paged_cache",
                "paddle_tpu_torch.inference.scheduler",
                "paddle_tpu_torch.inference.executor",
                "paddle_tpu_torch.inference.faults",
                "paddle_tpu_torch.inference.telemetry",
                "paddle_tpu_torch.inference.serving",
                "paddle_tpu_torch.inference.speculative",
                "paddle_tpu_torch.nn", "paddle_tpu_torch.nn.clip",
                "paddle_tpu_torch.nn.functional",
                "paddle_tpu_torch.nn.functional.activation",
                "paddle_tpu_torch.nn.functional.attention",
                "paddle_tpu_torch.nn.functional.common",
                "paddle_tpu_torch.nn.functional.extras",
                "paddle_tpu_torch.nn.functional.loss",
                "paddle_tpu_torch.nn.functional.norm",
                "paddle_tpu_torch.nn.layer", "paddle_tpu_torch.nn.layer.common",
                "paddle_tpu_torch.nn.layer.norm",
                "paddle_tpu_torch.nn.layer.transformer",
                "paddle_tpu_torch.nn.lora", "paddle_tpu_torch.nn.quant",
                "paddle_tpu_torch.nn.quant.quant_layers",
                "paddle_tpu_torch.optimizer", "paddle_tpu_torch.optimizer.lr",
                "paddle_tpu_torch.optimizer.optimizer",
                "paddle_tpu_torch.parallel",
                "paddle_tpu_torch.parallel.engine",
                "paddle_tpu_torch.parallel.offload",
                "paddle_tpu_torch.framework",
                "paddle_tpu_torch.framework.containers",
                "paddle_tpu_torch.framework.core",
                "paddle_tpu_torch.framework.dispatch",
                "paddle_tpu_torch.framework.flags",
                "paddle_tpu_torch.framework.monitor",
                "paddle_tpu_torch.framework.dtype",
                "paddle_tpu_torch.framework.io_state",
                "paddle_tpu_torch.framework.param_attr",
                "paddle_tpu_torch.framework.random",
                "paddle_tpu_torch.nn.initializer",
                "paddle_tpu_torch.nn.layer_base",
                "paddle_tpu_torch.nn.functional._spatial",
                "paddle_tpu_torch.nn.functional.conv",
                "paddle_tpu_torch.nn.functional.pooling",
                "paddle_tpu_torch.nn.layer.activation",
                "paddle_tpu_torch.nn.layer.container",
                "paddle_tpu_torch.nn.layer.conv",
                "paddle_tpu_torch.nn.layer.loss",
                "paddle_tpu_torch.nn.layer.pooling",
                "paddle_tpu_torch.nn.layer.extras",
                "paddle_tpu_torch.nn.layer.rnn",
                "paddle_tpu_torch.nn.utils",
                "paddle_tpu_torch.tensor",
                "paddle_tpu_torch.tensor._util",
                "paddle_tpu_torch.tensor.array",
                "paddle_tpu_torch.tensor.attribute",
                "paddle_tpu_torch.tensor.creation",
                "paddle_tpu_torch.tensor.einsum",
                "paddle_tpu_torch.tensor.linalg",
                "paddle_tpu_torch.tensor.logic",
                "paddle_tpu_torch.tensor.manipulation",
                "paddle_tpu_torch.tensor.math",
                "paddle_tpu_torch.tensor.random",
                "paddle_tpu_torch.tensor.search",
                "paddle_tpu_torch.tensor.stat",
                "paddle_tpu_torch.vision",
                "paddle_tpu_torch.vision.models",
                "paddle_tpu_torch.vision.models.resnet",
                "paddle_tpu_torch.vision.models._common",
                "paddle_tpu_torch.vision.models.alexnet",
                "paddle_tpu_torch.vision.models.densenet",
                "paddle_tpu_torch.vision.models.googlenet",
                "paddle_tpu_torch.vision.models.inceptionv3",
                "paddle_tpu_torch.vision.models.lenet",
                "paddle_tpu_torch.vision.models.mobilenetv1",
                "paddle_tpu_torch.vision.models.mobilenetv2",
                "paddle_tpu_torch.vision.models.mobilenetv3",
                "paddle_tpu_torch.vision.models.ocr",
                "paddle_tpu_torch.vision.models.shufflenetv2",
                "paddle_tpu_torch.vision.models.squeezenet",
                "paddle_tpu_torch.vision.models.vgg",
                "paddle_tpu_torch.vision.ops",
                "paddle_tpu_torch.vision.datasets",
                "paddle_tpu_torch.vision.transforms",
                "paddle_tpu_torch.vision.transforms.functional",
                "paddle_tpu_torch.io", "paddle_tpu_torch.io.bucketing",
                "paddle_tpu_torch.io.native",
                "paddle_tpu_torch.io.worker_pool",
                "paddle_tpu_torch.batch", "paddle_tpu_torch.reader",
                "paddle_tpu_torch.reader.decorator",
                "paddle_tpu_torch.metric", "paddle_tpu_torch.callbacks",
                "paddle_tpu_torch.hapi", "paddle_tpu_torch.hapi.callbacks",
                "paddle_tpu_torch.hapi.model",
                "paddle_tpu_torch.hapi.summary"]
# torch sees no card in the child, whatever the machine has
NO_CARD_ENV = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The module's torch work on one intra-op thread: the plain twins'
    row-at-a-time products are too small to split over a thread team
    that the other test processes share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def _port_sources():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_port_source_imports_jax_or_the_jax_package(path):
    roots = set(_imported_roots(path))
    assert not roots & {"jax", "jaxlib", "paddle_tpu"}, (path, roots)


def test_every_port_module_is_in_the_import_guard():
    found = {".".join(p.relative_to(ROOT).with_suffix("").parts)
             .removesuffix(".__init__") for p in PORT.rglob("*.py")}
    assert found == set(PORT_MODULES)


def test_importing_the_port_loads_neither_jax_nor_the_jax_package():
    code = ("import sys\n"
            f"for m in {PORT_MODULES!r}: __import__(m)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'paddle_tpu'))\n"
            "print('LOADED', bad)\n")
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120,
                       env=NO_CARD_ENV)
    assert p.returncode == 0, p.stderr
    assert "LOADED []" in p.stdout, p.stdout


def test_nn_utils_and_every_vision_model_import_without_jax():
    """``nn.utils`` and every name ``vision.models`` exports (the zoo and
    the OCR pair) import, and build on the CPU, with neither jax nor the
    JAX package loaded; without ``device`` a model needs the card."""
    code = ("import sys\n"
            "import paddle_tpu_torch.nn.utils as u\n"
            "import paddle_tpu_torch.vision.models as vm\n"
            "names = [getattr(vm, n) for n in vm.__all__]\n"
            "vm.LeNet(device='cpu'); vm.CRNN(10, in_channels=1, "
            "device='cpu'); vm.DBNet(device='cpu')\n"
            "assert u.weight_norm and len(names) > 60\n"
            "try:\n    vm.CRNN(10)\nexcept RuntimeError as e:\n"
            "    assert 'no CUDA device' in str(e)\n"
            "else:\n    raise AssertionError('CRNN built without a card')\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'paddle_tpu'))\n"
            "print('LOADED', bad)\n")
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120,
                       env=NO_CARD_ENV)
    assert p.returncode == 0, p.stderr
    assert "LOADED []" in p.stdout, p.stdout


def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        paddle_tpu_torch.resolve_device(None)
    cfg = llama_tiny_config(num_hidden_layers=1, vocab_size=64,
                            hidden_size=64, intermediate_size=128,
                            num_attention_heads=4, num_key_value_heads=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LlamaForCausalLM(cfg)
    model = LlamaForCausalLM(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        GenerationServer(model, cache="paged")
    srv = GenerationServer(model, cache="paged", device="cpu", max_len=32,
                           block_size=4, prefill_chunk=8)
    rid = srv.submit([1, 2, 3], max_new_tokens=2)
    assert len(srv.run()[rid]) == 5


def test_set_device_leaves_entry_points_on_cuda(monkeypatch):
    """``paddle.device.set_device("cpu")`` records a name, as the JAX
    package's does: ``device=None`` still means the card and raises
    without one."""
    from paddle_tpu_torch import device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(device, "_current_device", None)
    assert device.set_device("cpu") == "cpu" == device.get_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        paddle_tpu_torch.resolve_device(None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        paddle_tpu_torch.zeros([2])
    assert paddle_tpu_torch.zeros([2], device="cpu").device.type == "cpu"


def test_ernie_entry_points_default_to_cuda_and_raise_without_it(
        monkeypatch):
    """Every ERNIE head, the layers under it and the weight conversion
    build on the card unless told otherwise, and raise without one; built
    on the CPU, the finetune step runs there and launches no kernel."""
    from paddle_tpu_torch.models import ernie
    from paddle_tpu_torch.models.convert import ernie_params_from_jax
    from paddle_tpu_torch.nn import LayerNorm, Linear

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = ernie.ernie_tiny_config(num_hidden_layers=1)
    for head in (ernie.ErnieForSequenceClassification,
                 ernie.ErnieForTokenClassification,
                 ernie.ErnieForQuestionAnswering, ernie.ErnieForMaskedLM):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            head(cfg)
    for make in (lambda: Linear(4, 4), lambda: LayerNorm(4)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    model = ernie.ErnieForSequenceClassification(cfg, device="cpu")
    state = {n: p.detach().numpy() for n, p in model.named_parameters()}
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ernie_params_from_jax(state, cfg)
    eng = ParallelEngine(model, optimizer=AdamW(
        learning_rate=5e-5, parameters=model.named_parameters()),
        loss_fn=model.loss_fn)
    ops.reset_launch_counts()
    loss = eng.train_batch(torch.randint(0, 1024, (2, 128)),
                           torch.randint(0, 2, (2,)))
    assert loss.device.type == "cpu" and torch.isfinite(loss)
    assert ops.launch_counts() == dict.fromkeys(ops.KERNEL_WRAPPERS, 0)


def test_layer_norm_wrapper_raises_on_cpu_dtype_and_size():
    """The LayerNorm wrapper launches nothing for CPU tensors, mixed or
    unsupported dtypes, or a last dim that is not a multiple of its
    16-byte vector: each raises (the dtype and size checks follow the
    device check, so they are reached through a tensor that claims to be
    on the card)."""
    from paddle_tpu_torch.ops.fused_norm import layer_norm_cuda

    x, w = torch.zeros(4, 64), torch.zeros(64)
    before = layer_norm_cuda.launches
    with pytest.raises(ValueError, match="CUDA"):
        layer_norm_cuda(x, w, w, 1e-5)
    cuda = property(lambda t: True)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch.Tensor, "is_cuda", cuda)
        with pytest.raises(TypeError, match="bfloat16 or float32"):
            layer_norm_cuda(x.half(), w.half(), w.half(), 1e-5)
        with pytest.raises(TypeError, match="one dtype"):
            layer_norm_cuda(x.bfloat16(), w, w, 1e-5)
        with pytest.raises(ValueError, match="multiple of 8"):
            layer_norm_cuda(torch.zeros(4, 12, dtype=torch.bfloat16),
                            torch.zeros(12, dtype=torch.bfloat16),
                            torch.zeros(12, dtype=torch.bfloat16), 1e-5)
    assert layer_norm_cuda.launches == before


@pytest.mark.parametrize("case,exc,match", [
    ("head_dim_96", ValueError, r"head_dim 96 not in \(64, 128\)"),
    ("fp32", TypeError, r"model\.bfloat16\(\)")])
def test_flash_wrappers_take_head_dims_64_and_128_in_bf16_only(case, exc,
                                                               match):
    """The flash wrappers take D = 64 (ERNIE) and 128 (Llama); another
    head dim, or fp32 q/k/v, raise before any launch (reached through
    tensors that claim to be on the card)."""
    D = 96 if case == "head_dim_96" else 64
    dt = torch.float32 if case == "fp32" else torch.bfloat16
    q = torch.zeros(1, 2, 128, D, dtype=dt)
    rows = torch.zeros(1, 2, 128)
    before = {n: ops.KERNEL_WRAPPERS[n].launches for n in
              ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch.Tensor, "is_cuda", property(lambda t: True))
        with pytest.raises(exc, match=match):
            ops.flash_fwd_cuda(q, q, q, False, 0.125)
        with pytest.raises(exc, match=match):
            ops.flash_bwd_dq_cuda(q, q, q, q, rows, rows, False, 0.125)
        with pytest.raises(exc, match=match):
            ops.flash_bwd_dkv_cuda(q, q, q, q, rows, rows, False, 0.125)
    assert before == {n: ops.KERNEL_WRAPPERS[n].launches for n in before}


def _tiny_model():
    cfg = llama_tiny_config(num_hidden_layers=1, vocab_size=64,
                            hidden_size=64, intermediate_size=128,
                            num_attention_heads=4, num_key_value_heads=2)
    return LlamaForCausalLM(cfg, device="cpu")


def test_train_engine_defaults_to_cuda_and_raises_without_it(monkeypatch):
    """The engine trains where the model's parameters are: the model
    defaults to the card (and raises without one); a model built on the
    CPU trains there; parameters spread over devices raise."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ParallelEngine(LlamaForCausalLM(_tiny_model().cfg))
    split = _tiny_model()
    split.lm_head.weight = torch.nn.Parameter(
        torch.empty_like(split.lm_head.weight, device="meta"))
    with pytest.raises(ValueError, match="parameters are on"):
        ParallelEngine(split, optimizer=AdamW(
            parameters=split.named_parameters()))
    model = _tiny_model()
    opt = AdamW(parameters=model.named_parameters())
    eng = ParallelEngine(model, optimizer=opt)
    assert eng.device == torch.device("cpu")
    ids = torch.randint(0, 64, (2, 8))
    ops.reset_launch_counts()
    loss = eng.train_batch(ids, ids)
    assert loss.device.type == "cpu" and torch.isfinite(loss)
    # CPU tensors run the plain versions: no kernel launched
    assert ops.launch_counts() == dict.fromkeys(ops.KERNEL_WRAPPERS, 0)


@pytest.mark.parametrize("kwargs", [dict(fsdp=True),
                                    dict(abstract=True),
                                    dict(offload_opt_state=True),
                                    dict(donate=False),
                                    dict(alias_model_params=True),
                                    dict(mesh=type("Mesh", (), {"size": 2}))])
def test_unported_engine_options_raise(kwargs):
    model = _tiny_model()
    with pytest.raises(NotImplementedError):
        ParallelEngine(model, optimizer=AdamW(
            parameters=model.named_parameters()), **kwargs)


@pytest.mark.parametrize("field,value", [("moe_num_experts", 4),
                                         ("context_parallel", True),
                                         ("sequence_parallel", True),
                                         ("ulysses_parallel", True)])
def test_unported_model_options_raise(field, value):
    with pytest.raises(NotImplementedError, match=field):
        LlamaForCausalLM(llama_tiny_config(num_hidden_layers=1,
                                           **{field: value}), device="cpu")


@pytest.mark.parametrize("policy", ["bogus", "save_everything"])
def test_unknown_remat_policy_raises(policy):
    """An unknown ``remat_policy`` raises ValueError under ``remat=True``
    (as the JAX engine's), and is not looked at without it."""
    model = _tiny_model()
    opt = AdamW(parameters=model.named_parameters())
    with pytest.raises(ValueError, match="unknown remat_policy"):
        ParallelEngine(model, optimizer=opt, remat=True, remat_policy=policy)
    ParallelEngine(model, optimizer=opt, remat_policy=policy)


def _cpu_args(name):
    q = torch.zeros(1, 2, 8, 128, dtype=torch.bfloat16)
    k = torch.zeros(1, 1, 8, 128, dtype=torch.bfloat16)
    rows = torch.zeros(1, 2, 8)
    p = torch.zeros(8, 128, dtype=torch.bfloat16)
    f = torch.zeros(8, 128)
    return {"flash_fwd": (q, k, k, True, 0.1),
            "flash_bwd_dq": (q, k, k, q, rows, rows, True, 0.1),
            "flash_bwd_dkv": (q, k, k, q, rows, rows, True, 0.1),
            "fused_adamw": (p, p, f, f)}[name.removesuffix("_stream")]


@pytest.mark.parametrize("name", ["flash_fwd", "flash_bwd_dq",
                                  "flash_bwd_dkv", "fused_adamw",
                                  "flash_fwd_stream", "flash_bwd_dq_stream",
                                  "flash_bwd_dkv_stream"])
def test_new_cuda_wrappers_raise_on_cpu_tensors(name):
    wrapper = ops.KERNEL_WRAPPERS[name]
    kw = {} if name != "fused_adamw" else dict(
        scalars=torch.tensor([1e-3, 1.0, 1.0]), b1=0.9, b2=0.999, eps=1e-8,
        decay=0.0)
    before = wrapper.launches
    with pytest.raises(ValueError, match="CUDA"):
        wrapper(*_cpu_args(name), **kw)
    assert wrapper.launches == before


@pytest.mark.parametrize("kwargs", [dict(cache="bogus"),
                                    dict(spec=SpecConfig(k=0)),
                                    dict(telemetry=object()),
                                    dict(tick_window=0),
                                    dict(role="bogus"),
                                    dict(kernels="pallas")])
def test_unported_server_options_raise(kwargs):
    """Each unported option of the paged server raises
    NotImplementedError; ``cache``, ``tick_window``, ``spec``,
    ``telemetry`` and ``role`` are served, and a cache that is neither
    "dense" nor "paged", a window under one tick, an invalid
    ``SpecConfig``, a telemetry that is none of None, a bool or a
    ``ServingTelemetry`` or a role that is none of "any", "prefill" and
    "decode" raises ValueError, as in JAX."""
    model = LlamaForCausalLM(llama_tiny_config(num_hidden_layers=1),
                             device="cpu")
    exc = ValueError if {"cache", "tick_window", "spec", "telemetry",
                         "role"} & set(kwargs) else NotImplementedError
    with pytest.raises(exc):
        GenerationServer(model, device="cpu", **{"cache": "paged", **kwargs})


@pytest.mark.parametrize("alone", [False, True],
                         ids=["in_repo", "script_alone"])
def test_chip_smoke_fails_without_a_card_or_the_port(alone, tmp_path):
    """No card: exit non-zero and print no result line. Run alone in a
    directory without the port, the script cannot succeed either."""
    src = ROOT / "chip_smoke.py"
    if alone:
        (tmp_path / "chip_smoke.py").write_text(src.read_text())
        cwd, script = tmp_path, tmp_path / "chip_smoke.py"
    else:
        cwd, script = ROOT, src
    p = subprocess.run([sys.executable, str(script)], cwd=cwd,
                       capture_output=True, text=True, timeout=120,
                       env=NO_CARD_ENV)
    assert p.returncode != 0
    assert '"ok"' not in p.stdout


@pytest.mark.parametrize("batch,k,ok", [(16, 4, False), (13, 4, False),
                                        (16, 3, True), (12, 4, True),
                                        (65, None, False)])
def test_megakernel_rows_over_the_kernel_raise_at_construction(batch, k, ok):
    """``kernels="megakernel"`` takes B·W <= MAX_ROWS = 64 rows a tick (W =
    k+1 on a speculative server, 1 otherwise): past it the server refuses
    to build, naming the rule, instead of serving the per-layer programs;
    at it the server builds on the whole-tick kernel."""
    from paddle_tpu_torch.ops.decode_megakernel_cuda import MAX_ROWS

    model = _tiny_model()
    spec = None if k is None else SpecConfig(k=k)
    kw = dict(device="cpu", cache="paged", max_batch=batch, max_len=32,
              block_size=4, prefill_chunk=8, kernels="megakernel", spec=spec)
    try:
        if ok:
            srv = GenerationServer(model, **kw)
            assert srv._exec.megakernel
            assert batch * (k + 1) <= MAX_ROWS
        else:
            with pytest.raises(ValueError, match="MAX_ROWS = 64"):
                GenerationServer(model, **kw)
    finally:
        ops.set_kernel_mode("auto")
    assert ops.kernel_mode() == "auto"


@pytest.mark.parametrize("name", sorted(_UNPORTED_DEFAULTS))
def test_every_unported_server_default_still_raises(name):
    model = _tiny_model()
    with pytest.raises(NotImplementedError, match=name):
        GenerationServer(model, cache="paged", device="cpu",
                         **{name: object()})


def _new_wrapper_cases():
    """Per new kernel wrapper: (valid CPU arguments, the same with a wrong
    dtype, the same with an unsupported size)."""
    bf, i8, f32, i32 = torch.bfloat16, torch.int8, torch.float32, torch.int32
    z = torch.zeros

    def w8(xdt=bf, K=128):
        return (z(8, K, dtype=xdt), z(K, 256, dtype=i8), z(256, dtype=f32))

    def attn(qdt=bf, D=128):
        return (z(2, 1, 8, D, dtype=qdt), z(4, 16, 2, D, dtype=i8),
                z(4, 2, dtype=f32), z(4, 16, 2, D, dtype=i8),
                z(4, 2, dtype=f32), z(2, 3, dtype=i32), z(2, dtype=i32))

    def lora(xdt=bf, R=4):
        return (z(2, 1, 64, dtype=xdt), z(64, 128, dtype=bf),
                z(3, 1, 64, R), z(3, 1, R, 128), z(3), 0, z(2, dtype=i32))

    return {"w8_matmul": (w8(), w8(xdt=f32), w8(K=100)),
            "paged_attention_int8": (attn(), attn(qdt=f32), attn(D=64)),
            "fused_lora_matmul": (lora(), lora(xdt=f32), lora(R=65))}


@pytest.mark.parametrize("name", ["w8_matmul", "paged_attention_int8",
                                  "fused_lora_matmul"])
def test_int8_and_lora_wrappers_raise_on_cpu_dtype_and_size(name):
    """The three wrappers of this slice launch nothing for CPU tensors, a
    dtype or a size the kernel does not take: each raises."""
    wrapper = ops.KERNEL_WRAPPERS[name]
    ok, bad_dtype, bad_size = _new_wrapper_cases()[name]
    before = wrapper.launches
    with pytest.raises(ValueError, match="CUDA"):
        wrapper(*ok)
    with pytest.raises(TypeError):
        wrapper(*bad_dtype)
    with pytest.raises(ValueError, match="unsupported|head_dim"):
        wrapper(*bad_size)
    assert wrapper.launches == before


def _tick_args(dtype=torch.bfloat16, D=128, contiguous=True, inter=256):
    """CPU arguments of decode_tick_cuda at a 1-layer, 2-row tick of
    hidden 256 (2 heads of D, 1 KV head), intermediate ``inter``, bs 16."""
    from paddle_tpu_torch.ops import decode_megakernel as mk

    z = torch.zeros
    Hd = 2 * D
    layer = type("Layer", (), {})()
    layer.self_attn = type("A", (), {})()
    layer.mlp = type("M", (), {})()
    layer.input_layernorm = type("N", (), {"weight": z(Hd, dtype=dtype)})()
    layer.post_attention_layernorm = type(
        "N", (), {"weight": z(Hd, dtype=dtype)})()
    for obj, name, shape in ((layer.self_attn, "q_proj", (Hd, Hd)),
                             (layer.self_attn, "k_proj", (Hd, D)),
                             (layer.self_attn, "v_proj", (Hd, D)),
                             (layer.self_attn, "o_proj", (Hd, Hd)),
                             (layer.mlp, "gate_proj", (Hd, inter)),
                             (layer.mlp, "up_proj", (Hd, inter)),
                             (layer.mlp, "down_proj", (inter, Hd))):
        setattr(obj, name, type("L", (), {"weight": z(shape, dtype=dtype)})())
    model = type("Model", (), {})()
    model.model = type("Inner", (), {"layers": [layer]})()
    weights = mk.stack_layer_weights(model)
    x = z(2, 1, Hd, dtype=dtype)
    if not contiguous:
        x = z(2, 1, 2 * Hd, dtype=dtype)[..., ::2]
    pools = [z(4, 16, 1, D, dtype=dtype) for _ in range(2)]
    return (x, pools, z(2, 3, dtype=torch.int32), z(2, dtype=torch.int32),
            weights, z(2, 1, D // 2), z(2, 1, D // 2))


@pytest.mark.parametrize("case,exc,match", [
    ("cpu", ValueError, "CUDA"), ("dtype", TypeError, "bfloat16"),
    ("head_dim", ValueError, "head_dim"),
    ("non_contiguous", ValueError, "contiguous")])
def test_decode_tick_wrapper_raises_on_what_it_does_not_take(case, exc,
                                                             match):
    """The whole-tick wrapper launches nothing for a CPU tensor, a dtype, a
    head dim or a layout the kernel does not take: it raises, where it could
    have given way to the plain twin."""
    from paddle_tpu_torch.ops.decode_megakernel_cuda import decode_tick_cuda

    args = _tick_args(**{"cpu": {}, "dtype": dict(dtype=torch.float32),
                         "head_dim": dict(D=64),
                         "non_contiguous": dict(contiguous=False)}[case])
    before = decode_tick_cuda.launches
    with pytest.raises(exc, match=match):
        decode_tick_cuda(*args, eps=1e-5)
    assert decode_tick_cuda.launches == before


@pytest.mark.parametrize("inter,match", [(320, "CUDA"),
                                         (288, "multiples of 64")])
def test_decode_tick_wrapper_intermediate_rule(inter, match):
    """The kernel's weight tiles are 64 columns wide: an intermediate size
    that is a multiple of 64 but not of 256 passes the shape rules (the
    CPU tensors then raise for want of a card), one that is not a multiple
    of 64 raises on its shape; neither launches."""
    from paddle_tpu_torch.ops.decode_megakernel_cuda import decode_tick_cuda

    args = _tick_args(inter=inter)
    before = decode_tick_cuda.launches
    with pytest.raises(ValueError, match=match):
        decode_tick_cuda(*args, eps=1e-5)
    assert decode_tick_cuda.launches == before


@pytest.mark.parametrize("mode,wrapper", [("auto", True),
                                          ("megakernel", True),
                                          ("reference", False)])
def test_decode_tick_runs_the_twin_only_for_cpu_or_reference(
        monkeypatch, mode, wrapper):
    """``decode_tick`` hands a CUDA tensor to the kernel wrapper under
    "auto" and "megakernel" (never to the plain twin), a CPU tensor to the
    twin, and every tensor to the twin under "reference"."""
    from paddle_tpu_torch.ops import decode_megakernel as mk
    from paddle_tpu_torch.ops import decode_megakernel_cuda as mkc

    calls = []
    monkeypatch.setattr(mkc, "decode_tick_cuda",
                        lambda *a, **k: calls.append("kernel") or a[0])
    monkeypatch.setattr(mk, "_tick_plain",
                        lambda *a, **k: calls.append("twin") or a[0])
    x, pools, tables, pos, weights, c, s = _tick_args()
    ops.set_kernel_mode(mode)
    try:
        mk.decode_tick(x, pools, tables, pos, weights, c, s, block_size=16)
        assert calls == ["twin"]            # a CPU tensor: the twin
        monkeypatch.setattr(type(x), "is_cuda", property(lambda t: True))
        mk.decode_tick(x, pools, tables, pos, weights, c, s, block_size=16)
    finally:
        ops.set_kernel_mode("auto")
    assert calls[1] == ("kernel" if wrapper else "twin")


def _variant_args(case):
    """``_tick_args`` with int8 pools and LoRA tables, one of them made
    wrong as ``case`` says; returns (positional args, keyword args)."""
    from paddle_tpu_torch.ops import decode_megakernel as mk

    x, pools, tables, pos, weights, c, s = _tick_args()
    N, bs, KV, D = pools[0].shape
    sdt = torch.float64 if case == "scale_dtype" else torch.float32
    sshape = (N, KV + 1) if case == "scale_shape" else (N, KV)
    pools = [torch.zeros(N, bs, KV, D, dtype=torch.int8),
             torch.zeros(sshape, dtype=sdt)] * 2
    R = 32 if case == "rank" else 4
    fdt = torch.float64 if case == "factor_dtype" else torch.float32
    Hd, I = 2 * D, 256
    dims = {"q": (Hd, Hd), "k": (Hd, D), "v": (Hd, D), "o": (Hd, Hd),
            "gate": (Hd, I), "up": (Hd, I), "down": (I, Hd)}
    factors = {t: (torch.zeros(3, 1, i, R, dtype=fdt),
                   torch.zeros(3, 1, R, o, dtype=fdt))
               for t, (i, o) in dims.items()}
    if case == "factor_layout":
        factors["o"] = (torch.zeros(3, 1, R, Hd).transpose(2, 3),
                        factors["o"][1])
    adt = torch.int64 if case == "aidx_dtype" else torch.int32
    lora = mk.LoraTables(factors, torch.zeros(3), torch.zeros(2, dtype=adt),
                         R)
    kw = dict(eps=1e-5, lora=lora,
              dequant="bits" if case == "dequant" else "scores")
    return (x, pools, tables, pos, weights, c, s), kw


@pytest.mark.parametrize("case,exc,match", [
    ("cpu", ValueError, "CUDA"), ("scale_dtype", TypeError, "float32"),
    ("scale_shape", ValueError, "scales must be"),
    ("rank", ValueError, "rank 32"), ("factor_dtype", TypeError, "float32"),
    ("factor_layout", ValueError, "contiguous"),
    ("aidx_dtype", TypeError, "int32"), ("dequant", ValueError, "dequant")])
def test_decode_tick_wrapper_raises_on_int8_and_lora_arguments(case, exc,
                                                               match):
    """The int8 pools and the LoRA tables: a type, a shape, a rank or a
    layout the kernel does not take raises before any launch, and valid
    ones on the CPU still raise (no plain twin inside the wrapper)."""
    from paddle_tpu_torch.ops.decode_megakernel_cuda import decode_tick_cuda

    args, kw = _variant_args(case)
    before = decode_tick_cuda.launches
    with pytest.raises(exc, match=match):
        decode_tick_cuda(*args, **kw)
    assert decode_tick_cuda.launches == before


def test_dense_entry_points_default_to_cuda_and_raise_without_it(
        monkeypatch):
    """The dense server (the default cache) and GPT build on the card
    unless told otherwise, and raise without one; ``generate`` runs where
    the model lives."""
    from paddle_tpu_torch.models.gpt import GPTForCausalLM, gpt_tiny_config

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = _tiny_model()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        GenerationServer(model, prompt_buckets=(8,))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        GPTForCausalLM(gpt_tiny_config(num_hidden_layers=1))
    srv = GenerationServer(model, device="cpu", max_len=32,
                           prompt_buckets=(8,))
    assert srv.cache_mode == "dense"
    rid = srv.submit([1, 2, 3], max_new_tokens=2)
    assert len(srv.run()[rid]) == 5
    ops.reset_launch_counts()
    out = model.generate(torch.tensor([[1, 2, 3]]), max_new_tokens=2)
    assert out.device.type == "cpu" and out.shape == (1, 5)
    assert ops.launch_counts() == dict.fromkeys(ops.KERNEL_WRAPPERS, 0)


def test_dense_server_refuses_replaced_weights():
    """The dense graphs read the weights by address: a weight replaced
    after the server was built raises at the next run."""
    model = _tiny_model()
    srv = GenerationServer(model, device="cpu", max_len=32,
                           prompt_buckets=(8,))
    rid = srv.submit([1, 2, 3], max_new_tokens=2)
    assert len(srv.run()[rid]) == 5
    model.lm_head.weight = torch.nn.Parameter(
        model.lm_head.weight.detach().clone(), requires_grad=False)
    srv.submit([1, 2, 3], max_new_tokens=2)
    with pytest.raises(RuntimeError, match="replaced"):
        srv.run()


def test_failed_captures_raise_without_an_eager_rerun(monkeypatch):
    """A dense program's capture or a generate program's that fails
    raises; neither pass is run eagerly instead."""
    from paddle_tpu_torch import graphs
    from paddle_tpu_torch.inference import executor
    from paddle_tpu_torch.models import generation

    def refuse(*a, **k):
        raise RuntimeError("operation not permitted when stream is "
                           "capturing")

    model = _tiny_model()
    srv = GenerationServer(model, device="cpu", max_len=32,
                           prompt_buckets=(8,))
    srv._exec.graphs = True
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: "pool")
    monkeypatch.setattr(executor, "capture_graph", refuse)
    runs = []
    body = srv._exec._prefill
    srv._exec._prefill = lambda b: runs.append(b) or body(b)
    srv.submit([1, 2, 3], max_new_tokens=2)
    with pytest.raises(RuntimeError, match="capturing"):
        srv.run()
    assert runs == []
    monkeypatch.setattr(generation.Program, "graphed", lambda self: True)
    monkeypatch.setattr(graphs, "warm_up", lambda body, device: body())
    monkeypatch.setattr(graphs, "capture", refuse)
    with pytest.raises(RuntimeError, match="capturing"):
        model.generate(torch.tensor([[1, 2, 3]]), max_new_tokens=2)
    (prog,) = model._gen_cache.values()
    assert prog.replays == 0 and not prog.graphs


def test_framework_and_vision_entry_points_default_to_cuda(monkeypatch):
    """``to_tensor``, the creation functions, every layer that makes a
    tensor, ``load`` and ``resnet50`` build on the card unless told
    otherwise, and raise without one; a layer that makes no tensor needs
    no card."""
    import paddle_tpu_torch as paddle

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda: paddle.to_tensor([1.0]), lambda: paddle.ones([2]),
                 lambda: paddle.nn.Conv2D(3, 4, 3),
                 lambda: paddle.nn.BatchNorm2D(4),
                 lambda: paddle.nn.Linear(2, 2),
                 lambda: paddle.vision.models.resnet50(num_classes=10)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    assert isinstance(paddle.nn.ReLU(), paddle.nn.Layer)
    m = paddle.vision.models.resnet18(num_classes=10, device="cpu")
    assert {p.device.type for p in m.parameters()} == {"cpu"}


def test_data_metric_and_hapi_import_without_jax():
    """The data pipeline, the metrics, ``hapi`` and the rest of ``vision``
    import, build a ``Model`` over a CPU LeNet and load a batch through
    two worker processes, with neither jax nor the JAX package loaded."""
    code = ("import sys\n"
            "import paddle_tpu_torch as paddle\n"
            "T = paddle.vision.transforms\n"
            "ds = paddle.vision.datasets.MNIST(transform=T.Compose(\n"
            "    [T.ToTensor(), T.Normalize([0.5], [0.5])]))\n"
            "x, y = next(iter(paddle.io.DataLoader(ds, batch_size=4,\n"
            "                                      num_workers=2)))\n"
            "m = paddle.Model(paddle.vision.models.LeNet(device='cpu'))\n"
            "assert m.predict_batch(x)[0].shape == (4, 10)\n"
            "assert paddle.vision.ops.nms(x[:, 0, 0, :4]).dtype is not None\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'paddle_tpu'))\n"
            "print('LOADED', bad)\n")
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120,
                       env=NO_CARD_ENV)
    assert p.returncode == 0, p.stderr
    assert "LOADED []" in p.stdout, p.stdout


def test_hapi_model_runs_on_cuda_by_default_and_raises_without_it(
        monkeypatch):
    """``paddle.Model`` over a default-built network runs where the
    network is, the card; without one the network cannot be built. A
    batch the loader yields on the CPU is moved to the network's device
    (here a stand-in device check on a CPU network)."""
    import paddle_tpu_torch as paddle

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        paddle.Model(paddle.vision.models.LeNet())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        paddle.vision.ops.DeformConv2D(4, 4, 3)
    m = paddle.Model(paddle.vision.models.LeNet(device="cpu"))
    assert m._device() == torch.device("cpu")
    moved = m._to_device([np.zeros((1, 1, 28, 28), np.float32),
                          torch.zeros(1, dtype=torch.int64)])
    assert all(isinstance(v, torch.Tensor) and v.device.type == "cpu"
               for v in moved)


def test_the_loaders_workers_start_by_forkserver_once_cuda_is_up(
        monkeypatch):
    """A forked child of a process with CUDA up cannot use it: the pool's
    start method is ``forkserver`` then (or with other threads running),
    ``fork`` otherwise, ``PADDLE_TPU_MP_START`` over both."""
    import threading

    from paddle_tpu_torch.io import worker_pool

    monkeypatch.delenv("PADDLE_TPU_MP_START", raising=False)
    monkeypatch.setattr(threading, "active_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: False)
    assert worker_pool._mp_context().get_start_method() == "fork"
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    assert worker_pool._mp_context().get_start_method() == "forkserver"
    monkeypatch.setenv("PADDLE_TPU_MP_START", "spawn")
    assert worker_pool._mp_context().get_start_method() == "spawn"


@pytest.mark.parametrize("name,item", [("mesh", "A10")])
def test_mesh_and_profile_raise_naming_their_queue_items(name, item):
    """``mesh=`` is still unported: it raises NotImplementedError naming
    the ROADMAP item that ports it (``profile=`` is served since the
    autotuner was ported: tests/test_torch_autotune.py); ``role=`` is
    served on the paged path."""
    model = _tiny_model()
    with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
        GenerationServer(model, cache="paged", device="cpu",
                         **{name: "tp=2"})
    assert set(_UNPORTED_DEFAULTS) == {"mesh"}
    for role in ("any", "prefill", "decode"):
        srv = GenerationServer(model, cache="paged", device="cpu",
                               role=role)
        assert srv.role == role and srv.handoff_ready() == []


@pytest.mark.parametrize("role", ["prefill", "decode"])
def test_a_role_requires_the_paged_cache_as_in_jax(role):
    """``role=`` on the dense path raises the JAX server's ValueError, in
    its words."""
    from types import SimpleNamespace

    from paddle_tpu.inference.serving import GenerationServer as JServer
    from paddle_tpu.models import LlamaConfig as JConfig

    with pytest.raises(ValueError) as port:
        GenerationServer(_tiny_model(), device="cpu", role=role)
    with pytest.raises(ValueError) as jax_err:
        # the JAX server reads only the config before this check
        JServer(SimpleNamespace(cfg=JConfig()), role=role)
    assert str(port.value) == str(jax_err.value)
    assert "requires cache='paged'" in str(port.value)


def test_fleet_modules_and_a_worker_import_without_jax():
    """The fleet's modules import, and a replica worker builds its server
    on the CPU and answers through the frame codec, with neither jax nor
    the JAX package loaded in the parent or in the worker process."""
    code = ("import os, sys\n"
            "import paddle_tpu_torch.autotune, paddle_tpu_torch.fleetsim\n"
            "from paddle_tpu_torch.inference import (FleetRouter,\n"
            "    SubprocessReplica, ElasticAutoscaler)\n"
            "spec = {'model': {'config': dict(vocab_size=64, hidden_size=32,\n"
            "    intermediate_size=64, num_hidden_layers=1,\n"
            "    num_attention_heads=2, num_key_value_heads=1,\n"
            "    max_position_embeddings=64, dtype='float32'), 'seed': 1},\n"
            "    'server': dict(cache='paged', max_batch=1, max_len=32,\n"
            "    block_size=4, prefill_chunk=8), 'device': 'cpu'}\n"
            "h = SubprocessReplica(spec)\n"
            "rid = h.submit([1, 2, 3], max_new_tokens=2)\n"
            "while h.step(): pass\n"
            "assert len(h.take_results()[rid]) == 5\n"
            "h.ping()\n"
            "h.close()\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'paddle_tpu'))\n"
            "print('LOADED', bad)\n")
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120,
                       env={**NO_CARD_ENV, "OMP_NUM_THREADS": "1"})
    assert p.returncode == 0, p.stderr
    assert "LOADED []" in p.stdout, p.stdout
    # the worker's own interpreter: the module it runs, imported alone
    w = subprocess.run(
        [sys.executable, "-c",
         "import sys, paddle_tpu_torch.inference.replica_worker as w\n"
         "w.build_server({'model': {'config': dict(vocab_size=64, "
         "hidden_size=32, intermediate_size=64, num_hidden_layers=1, "
         "num_attention_heads=2, num_key_value_heads=1, "
         "max_position_embeddings=64, dtype='float32')}, 'server': "
         "dict(cache='paged', max_batch=1, max_len=32, block_size=4), "
         "'device': 'cpu'})\n"
         "print('LOADED', sorted(m for m in sys.modules if m.split('.')[0] "
         "in ('jax', 'jaxlib', 'paddle_tpu')))\n"],
        cwd="/", capture_output=True, text=True, timeout=120,
        env={**NO_CARD_ENV, "PYTHONPATH": str(ROOT)})
    assert w.returncode == 0, w.stderr
    assert "LOADED []" in w.stdout, w.stdout


def test_a_worker_and_its_handle_default_to_cuda_and_raise_without_it(
        monkeypatch):
    """A replica spec without ``device`` means the CUDA card: the worker's
    ``build_server`` and the ``SubprocessReplica`` handle raise where
    there is none, before any model or process exists; a worker on the
    card refuses the reference kernels."""
    from paddle_tpu_torch.inference import replica_worker
    from paddle_tpu_torch.inference.transport import SubprocessReplica

    spec = {"model": {"config": dict(num_hidden_layers=1)},
            "server": dict(cache="paged")}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        replica_worker.build_server(spec)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SubprocessReplica(spec)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    from paddle_tpu_torch.ops import _build

    monkeypatch.setattr(_build, "library", lambda: None)
    with pytest.raises(ValueError, match="kernels='reference' is refused"):
        replica_worker.build_server(
            {**spec, "server": dict(cache="paged", kernels="reference")})
