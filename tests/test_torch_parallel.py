"""The port's process-group meshes, collectives and depth-sharded sliding
windows, on the CPU over gloo, against their definitions and the JAX
package.

  - `initialize` is a no-op without a world; a mesh needs one; an entry
    point's --n_devices must be the world size.
  - The collectives with gradients (world 2): `all_sum_grad`,
    `all_gather_grad` and the depth halo exchange (zeros past the volume's
    ends, each halo's cotangent added back into the rows it came from),
    held exactly to the values their definitions give.
  - `sliding_window_inference_spatial` at world 2 and 4 (spawned ranks):
    the identity model reproduces the volume, across every slab boundary
    and with a depth that needs edge padding, at the tolerances of
    tests/test_spatial_sharded.py (rtol 1e-4, atol 1e-5); a small real 3D
    UNet's blended logits equal the JAX shard_map version on make_mesh(n)
    (the JAX conftest's virtual CPU devices) within float32 round-off
    (rtol 1e-4, atol 2e-6), with an unpadded depth.

The ranks run tests/_torch_dist_workers.py (torch only) and write .npz
files that this process reads.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ctseg_tpu.inference.spatial_sharded import (
    sliding_window_inference_spatial as jax_spatial,
)
from ctseg_tpu.models import SegmentationModel as JaxSegmentationModel
from ctseg_tpu.models.torch_import import import_monai_state_dict
from ctseg_tpu.parallel import make_mesh as jax_make_mesh
from ctseg_tpu_torch.models.unet import SegmentationModel
from ctseg_tpu_torch.parallel import distributed, mesh
from ctseg_tpu_torch.parallel.collectives import LOCAL
from tests import _torch_dist_workers as workers

FILTERS = (2, 4, 8, 16, 32)


def test_initialize_without_a_world_is_a_no_op(monkeypatch):
    for var in ("WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    assert distributed.initialize(device="cpu") is False
    assert not torch.distributed.is_initialized()
    assert distributed.local_device("cpu") == torch.device("cpu")
    monkeypatch.setenv("LOCAL_RANK", "3")
    assert distributed.local_device("cuda") == torch.device("cuda", 3)
    assert distributed.local_device("cuda:1") == torch.device("cuda", 1)


def test_meshes_need_a_world_and_flags_must_match_it():
    with pytest.raises(RuntimeError, match="initialize"):
        mesh.make_mesh()
    with pytest.raises(RuntimeError, match="initialize"):
        mesh.make_spatial_mesh(1, 2)
    assert distributed.mesh_from_flags(None, device="cpu") == (
        None, torch.device("cpu"))
    with pytest.raises(SystemExit, match="torchrun --nproc_per_node 2"):
        distributed.mesh_from_flags(2, device="cpu")
    # the single-process batch reduces nothing
    t = torch.arange(3.0)
    assert LOCAL.rows(t) is t and LOCAL.spatial(t) is t
    assert LOCAL.n_data == LOCAL.n_space == 1


def test_a_one_rank_mesh_view_shards_nothing():
    m = mesh.Mesh({"data": 2, "space": 2}, 3, None, None, None, (2, 3))
    assert (m.size, m.n_space, m.data_index, m.space_index) == (4, 2, 1, 1)
    dp = m.data_parallel()
    assert dp.shape == {"data": 4} and dp.data_index == 3
    x = torch.arange(8.0).reshape(4, 2)
    assert torch.equal(mesh.batch_sharding(dp, x), x[3:4])
    assert torch.equal(mesh.depth_slab(m, x, dim=0), x[2:4])


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("world2")
    jobs = [("collectives", "collectives", {})] + _inference_jobs(tmp)
    return workers.run(2, tmp, jobs)


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("world4")
    return workers.run(4, tmp, _inference_jobs(tmp))


def test_collectives_and_the_halo_match_their_definitions(world2):
    r0, r1 = workers.ranks(world2, "collectives")
    x = [r0["x"], r1["x"]]
    w = [r0["w"], r1["w"]]
    zero = np.zeros_like(x[0][..., :1])
    # ext: the left neighbour's last row, the slab, the right one's first
    np.testing.assert_array_equal(
        r0["ext"], np.concatenate([zero, x[0], x[1][..., :1]], axis=-1))
    np.testing.assert_array_equal(
        r1["ext"], np.concatenate([x[0][..., -1:], x[1], zero], axis=-1))
    # the halo's cotangent goes back to the rows it was copied from
    g0 = w[0][..., 1:-1].copy()
    g0[..., -1] += w[1][..., 0]
    g1 = w[1][..., 1:-1].copy()
    g1[..., 0] += w[0][..., -1]
    np.testing.assert_array_equal(r0["halo_grad"], g0)
    np.testing.assert_array_equal(r1["halo_grad"], g1)
    full = np.concatenate(x, axis=-1)
    weight = np.arange(full.size, dtype=np.float64).reshape(full.shape)
    for r, res in enumerate((r0, r1)):
        np.testing.assert_array_equal(res["gathered"], full)
        np.testing.assert_array_equal(
            res["gather_grad"], 2 * weight[..., 6 * r:6 * (r + 1)])
        np.testing.assert_array_equal(res["sum"], np.full(3, 3.0))
        # each rank's loss is sum(total^2), total = y + 2y; the backward
        # sums the cotangents 2 * total over both ranks
        np.testing.assert_array_equal(res["sum_grad"],
                                      np.full(3, 2 * 2 * 3.0 * (r + 1)))
        # host_local_batch_to_global: the rank's rows, the global size
        assert bool(res["rows_kept"]) and int(res["global_rows"]) == 6


# ------------------------------------------------------- spatial inference
def _volume(shape, seed):
    return np.random.default_rng(seed).random(shape).astype(np.float32)


def _port_model():
    return SegmentationModel(in_channels=1, out_channels=4, channels=FILTERS,
                             spatial_dims=3,
                             generator=torch.Generator().manual_seed(5))


def _inference_jobs(tmp):
    np.save(tmp / "identity.npy", _volume((48, 24, 24, 2), 0))
    np.save(tmp / "unpadded.npy", _volume((50, 16, 16, 1), 1))
    np.save(tmp / "edge.npy", _volume((37, 16, 16, 1), 2))
    torch.save({"kwargs": dict(in_channels=1, out_channels=4,
                               channels=FILTERS, spatial_dims=3),
                "state_dict": _port_model().state_dict()}, tmp / "model.pt")
    return [
        ("identity", "spatial_inference",
         dict(volume="identity.npy", patch=(16, 16, 16), batch_size=3)),
        ("identity_edge", "spatial_inference",
         dict(volume="edge.npy", patch=(8, 16, 16))),
        ("real", "spatial_inference",
         dict(volume="unpadded.npy", patch=(16, 16, 16),
              model_file="model.pt")),
    ]


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("tag,shape,seed", [
    ("identity", (48, 24, 24, 2), 0), ("identity_edge", (37, 16, 16, 1), 2)])
def test_spatial_inference_of_the_identity_is_the_volume(world, tag, shape,
                                                         seed, world2,
                                                         world4):
    outs = workers.ranks({2: world2, 4: world4}[world], tag)
    vol = _volume(shape, seed)
    for o in outs:  # every rank returns the whole blend
        assert o["out"].shape == vol.shape
        np.testing.assert_allclose(o["out"], vol, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("world", [2, 4])
def test_spatial_inference_of_a_model_matches_jax(world, world2, world4):
    outs = workers.ranks({2: world2, 4: world4}[world], "real")
    vol = _volume((50, 16, 16, 1), 1)
    for o in outs[1:]:  # every rank returns the whole blend
        np.testing.assert_array_equal(o["out"], outs[0]["out"])
    model = _port_model()
    params = import_monai_state_dict(model.state_dict(), 1, FILTERS)
    jmodel = JaxSegmentationModel(out_channels=4, channels=FILTERS)
    ref = jax_spatial(jnp.asarray(vol), lambda p: jmodel.apply(params, p),
                      patch_size=(16, 16, 16), mesh=jax_make_mesh(world),
                      batch_size=4, out_channels=4)
    assert outs[0]["out"].shape == (50, 16, 16, 4)
    np.testing.assert_allclose(outs[0]["out"], np.asarray(ref), rtol=1e-4,
                               atol=2e-6)
