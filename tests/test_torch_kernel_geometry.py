"""The per-op kernel-geometry tier of the port
(``paddle_tpu_torch/autotune/kernel_geometry.py`` and the ops that take a
geometry) against the JAX package's: the dataclasses' fields, validity
and occupancy arithmetic, the candidate lists and ``geometry_cost_proxy``
of every op under the ``"cpu"`` kind, the cache's keys and fingerprints,
the server's resolution map and ``sweep_kernel_geometry`` over one stub
``measure``. Then the port's own half: the Hopper model's candidates fit
a block's 227 KB and leave out the axes that wait for ROADMAP A9c, those
axes raise, ``LoRAGeometry.rank_pad`` and ``CEGeometry.rows`` give the
default's bits on the plain twins, and the norms' rows a block clamp as
the JAX ``_block_rows`` does."""
import json

import numpy as np
import pytest
import torch

import paddle_tpu.autotune.kernel_geometry as jkg
from paddle_tpu.autotune.cost import geometry_cost_proxy as jproxy
from paddle_tpu.autotune.search import sweep_kernel_geometry as jsweep
from paddle_tpu.ops import decode_megakernel as jmk
from paddle_tpu.ops.fused_norm import _block_rows

import paddle_tpu_torch.autotune.kernel_geometry as pkg
from paddle_tpu_torch import ops
from paddle_tpu_torch.autotune.cost import geometry_cost_proxy as pproxy
from paddle_tpu_torch.autotune.search import sweep_kernel_geometry as psweep
from paddle_tpu_torch.nn.lora import PooledFactors, lora_matmul
from paddle_tpu_torch.ops import decode_megakernel as pmk
from paddle_tpu_torch.ops.fused_ce import fused_linear_cross_entropy
from paddle_tpu_torch.ops.fused_norm import _rows_a_block

H100 = "NVIDIA H100 80GB HBM3"


@pytest.fixture(autouse=True)
def _reset_geometry():
    yield
    pkg.install_geometry_cache(None)
    jkg.install_geometry_cache(None)


_SHAPES = {
    "paged_attention": [dict(head_dim=128, block_size=16, window=1, rep=4,
                             blocks=128),
                        dict(head_dim=128, block_size=32, window=5, rep=4),
                        dict(head_dim=64, block_size=8, window=64, rep=8)],
    "fused_lora": [dict(seq=1, in_dim=4096, out_dim=4096, rank=8),
                   dict(seq=128, in_dim=1024, out_dim=1024, rank=16)],
    "flash_attention": [dict(head_dim=128, seq_q=2048, seq_k=2048),
                        dict(head_dim=64, seq_q=512, seq_k=8192)],
    "fused_norm": [dict(rows_total=8, width=4096),
                   dict(rows_total=4096, width=768)],
    "fused_ce": [dict(rows_total=4096, hidden=4096, vocab=128256),
                 dict(rows_total=1024, hidden=64, vocab=256)],
}


# ------------------------------------------------- the "cpu" kind is JAX's
@pytest.mark.parametrize("op", sorted(_SHAPES))
@pytest.mark.parametrize("quantized", [False, True])
def test_candidates_and_proxies_equal_jax_under_the_cpu_kind(op, quantized):
    for shape in _SHAPES[op]:
        for limit in (None, 1 << 20, 64 << 10):
            jc = jkg.geometry_candidates(op, quantized=quantized,
                                         vmem_limit_bytes=limit, **shape)
            pc = pkg.geometry_candidates(op, quantized=quantized,
                                         vmem_limit_bytes=limit,
                                         device_kind="cpu", **shape)
            assert [g.asdict() for g in jc] == [g.asdict() for g in pc]
            assert [type(g).__name__ for g in jc] == \
                [type(g).__name__ for g in pc]
            for g_j, g_p in zip(jc, pc):
                assert jproxy(op, g_j, quantized=quantized, **shape) == \
                    pproxy(op, g_p, device_kind="cpu", quantized=quantized,
                           **shape)
                assert jproxy(op, g_j, quantized=quantized, **shape) == \
                    pproxy(op, g_p, quantized=quantized, **shape)


def test_dataclasses_and_occupancy_arithmetic_equal_jax():
    for op in jkg.OP_FAMILIES:
        assert [f.name for f in jkg.OP_GEOMETRY[op].__dataclass_fields__
                .values()] == [f.name for f in pkg.OP_GEOMETRY[op]
                               .__dataclass_fields__.values()]
        assert jkg.default_geometry(op).asdict() == \
            pkg.default_geometry(op).asdict()
    pa = dict(head_dim=128, block_size=16, window=5, rep=4)
    for d in (1, 2, 4):
        for deq in ("scores", "early"):
            for q in (False, True):
                assert jkg.PagedAttentionGeometry(
                    kv_block_depth=d, dequant=deq, q_rows=8).vmem_bytes(
                        quantized=q, **pa) == pkg.PagedAttentionGeometry(
                        kv_block_depth=d, dequant=deq, q_rows=8).vmem_bytes(
                        quantized=q, **pa)
    for pad in (0, 8, 16, 128):
        assert jkg.LoRAGeometry(rank_pad=pad).vmem_bytes(
            seq=1, in_dim=64, out_dim=64, rank=4) == \
            pkg.LoRAGeometry(rank_pad=pad).vmem_bytes(
                seq=1, in_dim=64, out_dim=64, rank=4)
        assert jkg.LoRAGeometry(rank_pad=pad).padded_rank(5) == \
            pkg.LoRAGeometry(rank_pad=pad).padded_rank(5)
    mk = dict(hidden=4096, heads=32, kv_heads=8, head_dim=128,
              intermediate=14336, layers=32, batch=8, window=1,
              block_size=16)
    for ffn in (0, 512, 2048):
        for d in (1, 2, 4):
            for q in (False, True):
                assert jmk.MegakernelGeometry(
                    ffn_tile=ffn, prefetch_depth=d).vmem_bytes(
                        quantized=q, **mk) == pmk.MegakernelGeometry(
                        ffn_tile=ffn, prefetch_depth=d).vmem_bytes(
                        quantized=q, **mk)
    for bad in (dict(kv_block_depth=0), dict(q_rows=-1),
                dict(grid_order="x"), dict(dequant="late")):
        for mod in (jkg, pkg):
            with pytest.raises(ValueError):
                mod.PagedAttentionGeometry(**bad).validate()
    for n, want in ((4096, 512), (24, 16), (8, 8), (7, 5)):
        assert jkg._largest_divisor(n, want) == pkg._largest_divisor(n, want)


def _cache(mod):
    c = mod.GeometryCache()
    c.put("paged_attention", "bfloat16", 128, H100,
          mod.PagedAttentionGeometry(kv_block_depth=2))
    c.put("paged_attention", "int8", 128, "cpu",
          mod.PagedAttentionGeometry(grid_order="gbm", dequant="early"))
    c.put("fused_norm", "float32", 64, "cpu", mod.NormGeometry(rows=8))
    c.put("fused_ce", "float32", 64, "cpu", mod.CEGeometry(rows=8))
    c.put("fused_lora", "float32", 4, "cpu", mod.LoRAGeometry(rank_pad=8))
    return c


def test_cache_keys_fingerprints_and_resolution_equal_jax():
    jc, pc = _cache(jkg), _cache(pkg)
    assert jc.to_dict() == pc.to_dict()
    assert jc.fingerprint() == pc.fingerprint()
    assert pkg.GeometryCache.from_dict(jc.to_dict()) == pc
    assert pc.lookup("fused_norm", "float32", 64, "TPU v5e") is None
    with pytest.raises(ValueError, match="may not contain"):
        pc.put("fused_norm", "a|b", 1, "cpu", pkg.NormGeometry())
    jkg.install_geometry_cache(jc, source="swept")
    pkg.install_geometry_cache(pc, source="swept")
    for kv in ("none", "int8"):
        for rank in (None, 4):
            j = jkg.resolve_server_geometries(
                head_dim=128, hidden=64, dtype="float32", kv_quant=kv,
                lora_rank=rank, device_kind="cpu")
            p = pkg.resolve_server_geometries(
                head_dim=128, hidden=64, dtype="float32", kv_quant=kv,
                lora_rank=rank, device_kind="cpu")
            assert {op: (g.asdict(), s) for op, (g, s) in j.items()} == \
                {op: (g.asdict(), s) for op, (g, s) in p.items()}
    assert pkg.active_geometry_source() == "swept"


def _measure(mod):
    """A stub measure: seconds a function of the candidate, outputs equal
    but for the fastest candidate's (which the gate must reject)."""
    def measure(geom):
        d = geom.asdict()
        key = json.dumps(d, sort_keys=True)
        secs = 1.0 + (sum(map(ord, key)) % 97) / 10.0
        out = np.full((4, 4), 7.0, np.float32)
        if d == {"rows": 64}:
            out, secs = out + 1e-6, 0.01
        return out, secs
    return measure


@pytest.mark.parametrize("op,quantized,trunc", [
    ("fused_norm", False, None), ("fused_ce", False, 3),
    ("paged_attention", True, None), ("paged_attention", False, 5),
    ("fused_lora", False, None)])
def test_sweep_over_one_stub_measure_equals_jax(op, quantized, trunc):
    shape = dict(_SHAPES[op][0])
    runs = []
    for sweep, mod in ((jsweep, jkg), (psweep, pkg)):
        cache, logs = mod.GeometryCache(), []
        res = sweep(_measure(mod), op, dtype="float32", key=64,
                    device_kind="cpu", quantized=quantized, shape=shape,
                    max_candidates=trunc, cache=cache, log=logs.append)
        runs.append((res.to_dict(), cache.to_dict(), logs))
    assert runs[0] == runs[1]


# ------------------------------------------------------ the Hopper model
@pytest.mark.parametrize("op", sorted(_SHAPES))
@pytest.mark.parametrize("quantized", [False, True])
def test_hopper_candidates_fit_and_leave_out_the_a9c_axes(op, quantized):
    for shape in _SHAPES[op]:
        cands = pkg.geometry_candidates(op, quantized=quantized,
                                        device_kind=H100, **shape)
        assert cands[0] == pkg.default_geometry(op)
        assert len({json.dumps(g.asdict(), sort_keys=True)
                    for g in cands}) == len(cands)
        for g in cands:
            pkg.check_served(op, g, quantized=quantized,
                             rank=shape.get("rank"), hopper=True)
            if op == "paged_attention":
                assert g.q_rows == 0
                assert g.smem_bytes(quantized=quantized) <= \
                    pkg.HOPPER_SMEM_LIMIT
                assert g.dequant == "scores"
            elif op == "fused_lora":
                assert g.accum == "base_first"
                assert g.padded_rank(shape["rank"]) <= pkg.LORA_MAX_RANK
            elif op == "flash_attention":
                assert (g.block_q, g.block_kv) == (0, 0)
        if op == "paged_attention":
            depths = {g.kv_block_depth for g in cands}
            assert depths == {1, 2}
            assert len(cands) == 4          # two depths x two orders
        proxies = [pproxy(op, g, device_kind=H100, quantized=quantized,
                          **shape) for g in cands]
        assert all(p is not None and p > 0 for p in proxies)


def test_paged_layouts_of_the_default_are_todays():
    """The default geometry's layout is the kernel's before the schedules:
    82976 bytes (fp) and 100912 (int8) a block, two blocks an SM."""
    g = pkg.PagedAttentionGeometry()
    assert g.smem_bytes(quantized=False) == 82976
    assert g.smem_bytes(quantized=True) == 100912
    assert pkg.PagedAttentionGeometry(kv_block_depth=4).hopper_errors()
    for q in (False, True):
        assert not pkg.PagedAttentionGeometry(
            kv_block_depth=2).hopper_errors(quantized=q)


def test_megakernel_hopper_model():
    assert pmk.MegakernelGeometry().smem_bytes() == pmk.HOPPER_SMEM_LIMIT
    assert pmk.MegakernelGeometry().ring_stages() == 12
    assert pmk.MegakernelGeometry(prefetch_depth=1).ring_stages() == 6
    assert pmk.MegakernelGeometry(ffn_tile=1024).ffn_steps() == 16
    ok = pmk.MegakernelGeometry(prefetch_depth=1, ffn_tile=1024)
    assert ok.hopper_errors(intermediate=14336, rows=32) == []
    assert "x slab" in ok.hopper_errors(intermediate=14336, rows=64)[0]
    assert pmk.MegakernelGeometry(ffn_tile=96).hopper_errors(
        intermediate=14336, rows=8)
    assert "does not divide" in pmk.MegakernelGeometry(
        ffn_tile=1024).hopper_errors(intermediate=1000 * 64, rows=8)[0]


def test_a9c_axes_raise_where_they_are_resolved():
    for op, geom in (("paged_attention",
                      pkg.PagedAttentionGeometry(q_rows=16)),
                     ("paged_attention",
                      pkg.PagedAttentionGeometry(dequant="early")),
                     ("flash_attention",
                      pkg.FlashAttentionGeometry(block_kv=128)),
                     ("fused_lora", pkg.LoRAGeometry(accum="delta_first"))):
        for hopper in (False, True):
            with pytest.raises(NotImplementedError, match="A9c"):
                pkg.check_served(op, geom, rank=8, hopper=hopper)
    # flash attention resolves the installed cache at each call
    from paddle_tpu_torch.ops.flash_attention import flash_attention

    q = torch.randn(1, 2, 8, 16)
    flash_attention(q, q, q, causal=True)
    c = pkg.GeometryCache()
    c.put("flash_attention", "float32", 16, "cpu",
          pkg.FlashAttentionGeometry(block_q=128))
    pkg.install_geometry_cache(c)
    with pytest.raises(NotImplementedError, match="A9c"):
        flash_attention(q, q, q, causal=True)
    with ops.kernel_geometry({"flash_attention":
                              pkg.FlashAttentionGeometry()}):
        flash_attention(q, q, q, causal=True)   # the scope's wins
    # fused LoRA's issue order
    x = torch.randn(2, 1, 32)
    w = torch.randn(32, 128)
    ab = (torch.randn(2, 32, 4), torch.randn(2, 4, 128), torch.ones(2))
    with pytest.raises(NotImplementedError, match="A9c"):
        lora_matmul(x, w, ab, geometry=pkg.LoRAGeometry(accum="delta_first"))


# ------------------------------------------------- bits on the plain twins
def test_lora_rank_pad_is_bit_exact_on_the_plain_twin():
    g = torch.Generator().manual_seed(1)
    x = torch.randn(3, 2, 48, generator=g)
    w = torch.randn(48, 128, generator=g)
    a = torch.randn(3, 2, 48, 4, generator=g)       # (pages, L, in, R)
    b = torch.randn(3, 2, 4, 128, generator=g)
    s = torch.tensor([0.5, 0.0, 2.0])
    aidx = torch.tensor([2, 0, 1], dtype=torch.int32)
    for layer in (0, 1):
        pooled = PooledFactors(a, b, s, layer, aidx)
        ref = lora_matmul(x, w, pooled, geometry=pkg.LoRAGeometry())
        for pad in (8, 16, 128):
            geom = pkg.LoRAGeometry(rank_pad=pad)
            assert torch.equal(lora_matmul(x, w, pooled, geometry=geom), ref)
            assert torch.equal(
                lora_matmul(x, w, pooled.gather(), geometry=geom), ref)


def test_ce_row_subtiles_are_bit_exact_on_the_cpu():
    """``CEGeometry.rows`` on the plain fused CE: value and gradient equal
    the default's bit for bit here (the CPU product rounds each row alike
    at every M)."""
    g = torch.Generator().manual_seed(3)
    T, H, V = 64, 32, 128
    h = torch.randn(T, H, generator=g)
    w = torch.randn(H, V, generator=g)
    labels = torch.randint(0, V, (T,), generator=g)
    labels[::7] = -100

    def run(geom):
        hh = h.clone().requires_grad_()
        loss = fused_linear_cross_entropy(hh, w, labels, chunk_size=16,
                                          geometry=geom)
        loss.backward()
        return loss.detach(), hh.grad

    ref, ref_g = run(pkg.CEGeometry())
    for rows in (4, 8, 16, 64):
        out, out_g = run(pkg.CEGeometry(rows=rows))
        assert torch.equal(out, ref) and torch.equal(out_g, ref_g)
    with pytest.raises(ValueError, match="CEGeometry"):
        fused_linear_cross_entropy(h, w, labels, geometry=pkg.NormGeometry())


def test_norm_rows_a_block_clamp_as_jax():
    import jax.numpy as jnp

    for rows_total in (8, 32, 4096, 24):
        x = jnp.zeros((rows_total, 8), jnp.float32)
        for rows in (8, 16, 64, 256, 512):
            geom = pkg.NormGeometry(rows=rows)
            assert _rows_a_block(rows_total, geom) == _block_rows(
                x, rows_total, jkg.NormGeometry(rows=rows))
        assert _rows_a_block(rows_total, pkg.NormGeometry()) == 0
    with pytest.raises(ValueError, match="NormGeometry"):
        _rows_a_block(8, pkg.CEGeometry())
