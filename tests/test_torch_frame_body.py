"""PyTorch port, the host-side pieces of the frame body of K1 and K8
(csrc/frame_body.cuh), against the plain route and the JAX package:

- `table_parts`: the scene's own tensors that the kernels gather into their
  shared-memory tables must give, in order, the flat tables of the JAX
  kernel's small operands, bit for bit, and
  the wrapper must raise on a part of the wrong dtype, device or size;
- `box_cull_plain`, the mirror of the kernels' box cull
  (csrc/shade_core.cuh:box_may_hit): every ray that the JAX package's
  `scene/intersect.py:_box_hits` finds hitting a rounded box, and every
  segment that its occlusion test (`ops/shade_kernel.py:_box_occludes`)
  finds blocked, must pass the cull, on seeded rays: random, grazing the
  boxes' bounds, from inside a box, parallel to the axes, and the path
  tracer's (K7's) own: path rays leaving plane, sphere and box surfaces
  and light-test segments toward the light; and the geometry pass's (K3's)
  camera rays from a view aimed at the box and from the raycast's view;
  three boxes. Where the cull rules out every box, the path tracer's
  inside-hit trace (`ops/path_kernel.py:_trace_inside`) must find what it
  finds without the boxes, bit for bit;
- `geometry_kernel.near_a_box_plain`, the mirror of the geometry pass's
  test against each box's bounding sphere, which leaves the boxes out of
  its trace before the cull, must pass every ray that the cull passes with
  any tmax, on the same rays.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_helpers import to_torch_camera, to_torch_scene
from kylespathtracer_tpu.ops import frame_kernel as jfk
from kylespathtracer_tpu.ops import path_kernel as jpk
from kylespathtracer_tpu.ops import shade_kernel as jsk
from kylespathtracer_tpu.render.camera import Camera
from kylespathtracer_tpu.scene import default_scene
from kylespathtracer_tpu.scene.intersect import _box_hits
from kylespathtracer_tpu.scene.scene import sphere_scene
from kylespathtracer_tpu_torch.ops import adjoint_variants as av
from kylespathtracer_tpu_torch.ops import frame_kernel as fk
from kylespathtracer_tpu_torch.ops import geometry_kernel as gk

CAM_LOC = av.VIEW_LOC
CAM = Camera.create(loc=CAM_LOC, orient=av.RAYCAST_VIEW)
# The box-aimed view and the raycast's view of the `primary` ray family.
PRIMARY_VIEWS = (av.BOX_AIMED, av.RAYCAST_VIEW)
# The default room's box and two more: a thin slab with a wide rounding and
# a flat plate with a tight one.
BOXES = np.array(av.THREE_BOXES, np.float32)
N = 4096


def _scenes():
    spheres = sphere_scene(
        [[5.5, 1.0, 0.0], [4.0, 0.5, 1.0], [6.0, 2.5, -1.5]], [1.0, 0.5, 0.7],
        [[0.8, 0.2, 0.2], [0.2, 0.8, 0.2], [0.2, 0.2, 0.8]],
    )
    boxes = default_scene().replace(boxes=jnp.asarray(BOXES), box_ids=jnp.asarray([7, 8, 9], jnp.int32))
    return {"default": default_scene(), "spheres": spheres, "three_boxes": boxes}


@pytest.mark.parametrize("case", ["default", "spheres", "three_boxes"])
def test_table_parts_give_the_packed_tables(case):
    jscene = _scenes()[case]
    scene, cam = to_torch_scene(jscene), to_torch_camera(CAM)
    f, i = fk.table_parts(scene, cam)
    packed_f, packed_i = torch.cat([t.reshape(-1) for t in f]), torch.cat([t.reshape(-1) for t in i])
    # The JAX kernel's small operands, in the same order.
    ops = [np.asarray(a) for a in jfk.small_operands(jscene, CAM, 3)]
    for k, n in zip(range(6), np.repeat(fk._counts(scene), 2)):  # JAX pads a zero-row table to one row
        ops[k] = ops[k][:n]
    want_f = np.concatenate([ops[k].reshape(-1) for k in (0, 2, 4, 6, 7, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18)])
    want_i = np.concatenate([ops[k].reshape(-1) for k in (1, 3, 5, 8)])
    np.testing.assert_array_equal(packed_f.numpy(), want_f)
    np.testing.assert_array_equal(packed_i.numpy(), want_i)
    # The sizes the kernel's offsets (make_tables) are the running sums of.
    sizes = fk.part_sizes(*fk._counts(scene), int(scene.materials.s0.shape[0]))
    assert [t.numel() for t in f] == list(sizes[0]) and [t.numel() for t in i] == list(sizes[1])


@pytest.mark.parametrize("fault", ["dtype", "device", "size"])
def test_table_parts_raise_on_a_wrong_part(fault):
    scene, cam = to_torch_scene(default_scene()), to_torch_camera(CAM)
    m = scene.materials
    bad = {
        "dtype": lambda: dataclasses.replace(scene, planes=scene.planes.double()),
        "device": lambda: dataclasses.replace(
            scene, materials=dataclasses.replace(m, s1=torch.empty(m.s1.shape, device="meta"))),
        "size": lambda: dataclasses.replace(
            scene, materials=dataclasses.replace(m, alb_const=torch.cat([m.alb_const, m.alb_const[:1]]))),
    }[fault]()
    with pytest.raises(ValueError, match="table part"):
        fk.table_parts(bad, cam)


EPS = 1e-3
LIGHT = np.array([6.0, 5.0, -4.0, 1.0], np.float32)  # the default room's light sphere


def _surface_points(rng):
    """Seeded points [N,3] on the three-box room's surfaces, with their
    outward unit normals: a third on the planes within 4 units of a box,
    a third on the light sphere, a third on the rounded boxes (faces, edges
    and corners: a core-box point nearest to a random point around it,
    pushed out by the rounding radius)."""
    kind = rng.integers(0, 3, N)
    box = BOXES[rng.integers(0, len(BOXES), N)]
    planes = np.array([[0.0, 1.0, 0.0, 0.0], [0.0, -1.0, 0.0, 10.0], [-1.0, 0.0, 0.0, 10.0],
                       [0.0, 0.0, 1.0, 10.0]], np.float32)[rng.integers(0, 4, N)]
    near = box[:, :3] + rng.uniform(-4.0, 4.0, (N, 3))
    p_plane = near - planes[:, :3] * (np.sum(near * planes[:, :3], -1) + planes[:, 3])[:, None]
    v = rng.normal(size=(N, 3))
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    p_sphere, n_sphere = LIGHT[:3] + v * LIGHT[3], v
    h, r = box[:, 3:6], box[:, 6:7]
    e = box[:, :3] + rng.uniform(-1.6, 1.6, (N, 3)) * (h + r)
    q = box[:, :3] + np.clip(e - box[:, :3], -h, h)
    out = e - q
    n_box = np.where(np.linalg.norm(out, axis=-1, keepdims=True) > 1e-6, out, v)
    n_box /= np.linalg.norm(n_box, axis=-1, keepdims=True)
    p_box = q + n_box * r
    pick = kind[:, None]
    p = np.where(pick == 0, p_plane, np.where(pick == 1, p_sphere, p_box))
    n = np.where(pick == 0, planes[:, :3], np.where(pick == 1, n_sphere, n_box))
    return p, n


def _cos_hemisphere(n, rng):
    """Cosine-weighted unit directions [N,3] around the unit normals n."""
    u1, u2 = rng.random(N), rng.random(N)
    a = np.where(np.abs(n[:, :1]) < 0.9, np.array([[1.0, 0.0, 0.0]]), np.array([[0.0, 1.0, 0.0]]))
    f = np.cross(n, a)
    f /= np.linalg.norm(f, axis=-1, keepdims=True)
    g = np.cross(n, f)
    rad, phi = np.sqrt(u1)[:, None], 2.0 * np.pi * u2[:, None]
    d = f * rad * np.cos(phi) + g * rad * np.sin(phi) + n * np.sqrt(1.0 - u1)[:, None]
    return d / np.linalg.norm(d, axis=-1, keepdims=True)


def _rays(family: str, rng):
    """Seeded rays (origins, unit directions) [N,3] of one family, and for
    the light-test segments (`nee`) their lengths [N]."""
    def unit(v):
        return v / np.linalg.norm(v, axis=-1, keepdims=True)

    if family == "path":
        # Leaving a surface off its normal by ±EPS, as K7's continuation
        # rays do: reflected into the cosine hemisphere, or transmitted
        # into the body.
        p, n = _surface_points(rng)
        side = np.where(rng.random((N, 1)) < 0.5, 1.0, -1.0)
        return ((p + n * side * EPS).astype(np.float32), _cos_hemisphere(n * side, rng).astype(np.float32),
                None)
    if family == "primary":
        # K3's camera rays at 64x32 (ops/frame_kernel.py:_raygen, fov 1.5)
        # from a view aimed at the default room's box and from chip_smoke.py
        # phase 13's view, both at CAM's location; rng is not read.
        rays = []
        for orient in PRIMARY_VIEWS:
            _, _, ro, rd = fk._raygen((32, 64), torch.tensor([CAM_LOC]), torch.tensor([orient]), 64, 32, 1.5, 0,
                                      "cpu")
            rays.append((torch.stack(ro, -1).reshape(-1, 3), torch.stack(rd, -1).reshape(-1, 3)))
        return (torch.cat([r[0] for r in rays]).numpy(), torch.cat([r[1] for r in rays]).numpy(), None)
    if family == "nee":
        # From a surface point off its normal toward a point on the light.
        p, n = _surface_points(rng)
        o = p + n * EPS
        v = unit(rng.normal(size=(N, 3)))
        seg = LIGHT[:3] + v * LIGHT[3] - o
        return o.astype(np.float32), unit(seg).astype(np.float32), np.linalg.norm(seg, axis=-1).astype(np.float32)

    box = BOXES[rng.integers(0, len(BOXES), N)]
    grown = box[:, 3:6] + box[:, 6:7]
    if family == "random":
        # From anywhere in the room toward a box's neighbourhood.
        o = rng.uniform(-10.0, 10.0, (N, 3))
        d = unit(box[:, :3] + rng.uniform(-3.0, 3.0, (N, 3)) * grown - o)
    elif family == "grazing":
        # Aimed at points within 2e-3 of the box's grown bounds: edges and
        # corners of the rounded shape, hit or missed by a hair.
        q = rng.uniform(-1.0, 1.0, (N, 3))
        axis = rng.integers(0, 3, N)
        q[np.arange(N), axis] = np.sign(q[np.arange(N), axis])
        target = box[:, :3] + q * grown + rng.uniform(-2e-3, 2e-3, (N, 3))
        o = target + unit(rng.normal(size=(N, 3))) * rng.uniform(3.0, 15.0, (N, 1))
        d = unit(target - o)
    elif family == "inside":
        o = box[:, :3] + rng.uniform(-1.0, 1.0, (N, 3)) * grown
        d = unit(rng.normal(size=(N, 3)))
    else:  # axis-parallel: one or two direction components exactly zero
        o = box[:, :3] + rng.uniform(-2.0, 2.0, (N, 3)) * grown
        d = rng.normal(size=(N, 3))
        d[rng.random((N, 3)) < 0.5] = 0.0
        d[np.all(d == 0.0, axis=-1), 0] = 1.0
        d = unit(d)
    return o.astype(np.float32), d.astype(np.float32), None


FAMILIES = ["random", "grazing", "inside", "axis", "path", "nee", "primary"]


@pytest.mark.parametrize("family", FAMILIES)
def test_box_cull_passes_every_hit(family):
    """Every (ray, box) that _box_hits finds passes the cull, with tmax the
    far bound (INF_T) and with tmax the hit itself (the kernels cull with
    the nearest hit so far, which is no nearer than a hit that wins)."""
    o, d, _ = _rays(family, np.random.default_rng(FAMILIES.index(family)))
    scene = _scenes()["three_boxes"]
    t = np.asarray(_box_hits(scene, jnp.asarray(o), jnp.asarray(d)))  # [N, B]
    hit = t < 1e8
    assert hit.sum() > 100, "too few hits; the check is vacuous"
    boxes, ot, dt = torch.from_numpy(BOXES), torch.from_numpy(o), torch.from_numpy(d)
    far = fk.box_cull_plain(boxes, ot, dt, torch.full((N,), 1e9)).numpy()
    assert far[hit].all(), f"{(~far[hit]).sum()} hits culled"
    for b in range(len(BOXES)):
        tight = fk.box_cull_plain(boxes[b:b + 1], ot, dt, torch.from_numpy(np.where(hit[:, b], t[:, b], 1e9)))
        assert tight.numpy()[hit[:, b], 0].all()
    if family == "random":
        assert (~far).mean() > 0.3, "the cull rules out too few rays to be worth its test"


@pytest.mark.parametrize("family", FAMILIES)
def test_box_cull_passes_every_occluded_segment(family):
    """Every segment (0, tmax) that the occlusion test finds blocked by a
    box passes the cull with that tmax."""
    rng = np.random.default_rng(10 + FAMILIES.index(family))
    o, d, tmax = _rays(family, rng)
    if tmax is None:
        tmax = rng.uniform(0.05, 20.0, N).astype(np.float32)
    sc = {"boxes": jnp.asarray(BOXES)}
    oj, dj = tuple(jnp.asarray(o[:, k]) for k in range(3)), tuple(jnp.asarray(d[:, k]) for k in range(3))
    cull = fk.box_cull_plain(torch.from_numpy(BOXES), torch.from_numpy(o), torch.from_numpy(d),
                             torch.from_numpy(tmax)).numpy()
    blocked_any = 0
    for b in range(len(BOXES)):
        blocked = np.asarray(jsk._box_occludes(sc, b, oj, dj, jnp.asarray(tmax)))
        blocked_any += int(blocked.sum())
        assert cull[blocked, b].all(), f"box {b}: {(~cull[blocked, b]).sum()} blocked segments culled"
    assert blocked_any > 100, "too few blocked segments; the check is vacuous"


# From inside a box's bounds the cull passes every ray: nothing to check there.
@pytest.mark.parametrize("family", [f for f in FAMILIES if f != "inside"])
def test_box_cull_leaves_the_inside_hit_trace(family):
    """K7 traces with far sphere roots and culls each box with tmax the
    nearest plane or sphere hit: where the cull rules out every box, the
    JAX package's inside-hit trace with the boxes finds the same t and oid,
    bit for bit, as without them (so every ray on which a box wins passes
    the cull)."""
    o, d, _ = _rays(family, np.random.default_rng(20 + FAMILIES.index(family)))
    jscene = _scenes()["three_boxes"]
    sc = dict(zip(jfk.SC_KEYS, jfk.small_operands(jscene, CAM, 0)[:17]))
    oj, dj = tuple(jnp.asarray(o[:, k]) for k in range(3)), tuple(jnp.asarray(d[:, k]) for k in range(3))
    excl = jnp.full((N,), -1, jnp.int32)
    nP, nS = int(jscene.planes.shape[0]), int(jscene.spheres.shape[0])
    t_all, id_all = (np.asarray(a) for a in jpk._trace_inside(sc, oj, dj, excl, nP, nS, len(BOXES)))
    t_ps, id_ps = (np.asarray(a) for a in jpk._trace_inside(sc, oj, dj, excl, nP, nS, 0))
    # The unpulled nearest plane or sphere hit; none (or beyond ZFAR): no bound.
    tmax = np.where(id_ps > 0, t_ps + EPS, 1e9).astype(np.float32)
    cull = fk.box_cull_plain(torch.from_numpy(BOXES), torch.from_numpy(o), torch.from_numpy(d),
                             torch.from_numpy(tmax)).numpy()
    ruled_out = ~cull.any(-1)
    box_wins = (t_all != t_ps) | (id_all != id_ps)
    assert ruled_out.sum() > 100 and box_wins.sum() > 100, "the check is vacuous"
    np.testing.assert_array_equal(t_all[ruled_out], t_ps[ruled_out])
    np.testing.assert_array_equal(id_all[ruled_out], id_ps[ruled_out])


@pytest.mark.parametrize("family", FAMILIES)
def test_near_a_box_passes_what_the_cull_passes(family):
    """Every (ray, box) that the cull passes with no bound on t passes the
    geometry pass's bounding-sphere test, which therefore only leaves out
    boxes that the cull would rule out; from the room it rules out most."""
    o, d, _ = _rays(family, np.random.default_rng(30 + FAMILIES.index(family)))
    boxes, ot, dt = torch.from_numpy(BOXES), torch.from_numpy(o), torch.from_numpy(d)
    cull = fk.box_cull_plain(boxes, ot, dt, torch.full((N,), 1e9)).numpy()
    near = gk.near_a_box_plain(boxes, ot, dt).numpy()
    assert cull.sum() > 100, "the cull passes too few rays; the check is vacuous"
    assert near[cull].all(), f"{(~near[cull]).sum()} rays that the cull passes left out"
    if family in ("random", "primary"):
        assert (~near).mean() > 0.3, "the sphere test rules out too few rays to be worth its test"
