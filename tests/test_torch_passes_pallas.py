"""PyTorch port, the pass pipeline with `shade_backend="pallas"` against
the JAX package's, frame by frame over the 3-frame pan of
tests/test_torch_passes.py (`_torch_helpers.pass_pan_matches_jax`): the
shade kernel K4 runs its plain version here (CPU tensors) and the JAX
kernel `dual_mis_pallas` in interpret mode. Tolerance: atol 2e-4 (rtol
1e-5); `oid` exact."""

from _torch_helpers import pass_pan_matches_jax
from kylespathtracer_tpu_torch.ops import shade_kernel as sk


def test_pass_pipeline_pallas_pan_matches_jax():
    before = sk.LAUNCHES
    pass_pan_matches_jax(dict(shade_backend="pallas"))
    assert sk.LAUNCHES == before  # CPU tensors: the plain version
