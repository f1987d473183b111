"""The vision model zoo of the PyTorch port
(``paddle_tpu_torch/vision/models/{lenet,alexnet,vgg,mobilenetv1,
mobilenetv2,mobilenetv3,squeezenet,shufflenetv2,densenet,googlenet,
inceptionv3}.py``) against the JAX package on the CPU, fp32: one eval
forward of each family at about the smallest input it takes (LeNet 28 x
28 on one channel; GoogLeNet 192, the least its auxiliary heads' fixed
widths allow; InceptionV3 75; the rest 32 or 64), B = 1, on the port's
seeded weights carried to the JAX model and back through
``layer_params_from_jax`` (parameters and BatchNorm statistics, name for
name). GoogLeNet returns its two auxiliary heads beside the logits, as
the JAX package's does.

The JAX forward runs as one compiled program (``jax_forward``: each
eager op compiles per shape, and DenseNet-121's first eager forward takes
~50 s, its compiled one 1.5 s). Tolerance: the largest |difference| over the largest |logit|
within 2e-5 (measured at most 3.4e-6, MobileNetV1)."""
import numpy as np
import pytest
import torch

import paddle_tpu.vision.models as jvm
from paddle_tpu.jit import state_values
import paddle_tpu_torch as pt
from paddle_tpu_torch.models.convert import layer_params_from_jax
from torch_tensor_parity import host, jax_forward, jax_host_init

TOL = 2e-5
CLASSES = 10

# (constructor, input size, channels)
FAMILIES = [("LeNet", 28, 1), ("alexnet", 64, 3), ("vgg11", 32, 3),
            ("mobilenet_v1", 32, 3), ("mobilenet_v2", 32, 3),
            ("mobilenet_v3_small", 32, 3), ("squeezenet1_1", 32, 3),
            ("shufflenet_v2_x1_0", 32, 3), ("densenet121", 32, 3),
            ("googlenet", 192, 3), ("inception_v3", 75, 3)]


def _flat(out):
    """The outputs as one array (GoogLeNet's three heads side by side)."""
    if isinstance(out, (list, tuple)):
        return np.concatenate([_flat(o) for o in out], -1)
    return host(out)


@pytest.mark.parametrize("name,size,channels", FAMILIES,
                         ids=[f[0] for f in FAMILIES])
def test_eval_forward_matches_jax(name, size, channels):
    torch.manual_seed(0)
    tm = getattr(pt.vision.models, name)(num_classes=CLASSES, device="cpu")
    state = {n: t.detach().numpy().copy() for n, t in
             list(tm.named_parameters()) + list(tm.named_buffers())}
    with jax_host_init():
        jm = getattr(jvm, name)(num_classes=CLASSES)
    missing, unexpected = jm.set_state_dict(state)
    assert not missing and not unexpected, (missing[:3], unexpected[:3])
    # back through the converter: every name of the JAX state is the
    # port's (it raises on a missing, unexpected or mis-shaped one)
    with torch.no_grad():
        for t in list(tm.parameters()) + list(tm.buffers()):
            t.zero_()
    layer_params_from_jax(
        {n: np.asarray(v) for n, v in state_values(jm).items()}, tm)
    x = np.random.RandomState(1).randn(1, channels, size, size).astype(
        "float32")
    jm.eval()
    tm.eval()

    j = _flat(jax_forward(jm, x))
    with torch.no_grad():
        t = tm(torch.from_numpy(x))
    if name == "googlenet":
        assert isinstance(t, tuple) and len(t) == 3
    t = _flat(t)
    assert t.shape == j.shape
    err = np.abs(t - j).max() / np.abs(j).max()
    assert err <= TOL, err
