"""PyTorch port, frame kernel module (K1) against the JAX package's real
`pl.pallas_call` (interpret mode), two row blocks: the port's plain version
reproduces the TPU kernel itself, not only its jnp body. Kept to one small
case in its own file: the interpreter costs tens of seconds."""

import jax.numpy as jnp
import numpy as np

from _torch_helpers import np_, to_torch_camera, to_torch_config, to_torch_scene
from kylespathtracer_tpu.ops import frame_kernel as jfk
from kylespathtracer_tpu.render.camera import Camera
from kylespathtracer_tpu.scene import default_scene
from kylespathtracer_tpu.utils.config import RenderConfig
from kylespathtracer_tpu_torch.ops import frame_kernel as fk


def test_frame_forward_matches_pallas_interpret():
    cam = Camera.create(loc=(3.0, 2.0, -3.0), orient=(0.0, 0.7))
    cfg = RenderConfig(width=64, height=16)
    ref = jfk.frame_forward_pallas(
        default_scene(), cam, jnp.int32(3), cfg, block_rows=8, interpret=True
    )
    out = fk.frame_forward(
        to_torch_scene(default_scene()), to_torch_camera(cam), 3, to_torch_config(cfg)
    )
    assert (np_(out["oid"]) == np.asarray(ref["oid"])).all()
    for k in ("add_d", "add_s", "alb", "ene", "depth", "curv"):
        np.testing.assert_allclose(
            np_(out[k]), np.asarray(ref[k]), atol=2e-5, rtol=1e-5, err_msg=k
        )
