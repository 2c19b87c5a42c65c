"""The port's ProcessMesh (slam_framework_torch/parallel/multihost.py): two
ranks spawned with torch.multiprocessing, joined by gloo through a FileStore
in the test's own directory (no port: the suite runs in several workers at
once), run the demo's distributed programs
(slam_framework_torch/tools/multihost_demo.py): the round-robin and the
owner-keyed sharded global BA, `migrate_points` and the edge-sharded pose
graph. While they run, the same programs go through `LocalMesh(2, "cpu")` in
this process and through the reference's sharded programs on 2 of its CPU
devices.

Held: every result within 1e-5 of `LocalMesh(2)`'s (the same program; gloo
sums in another order than the stacked ranks), the migrated rows bit-equal to
`LocalMesh(2)`'s and to the reference's, cameras and vertices within 1e-3 m of
the reference's sharded results (the bound of tests/test_multihost.py). A CUDA
mesh with fewer GPUs than ranks raises; the NCCL case needs two GPUs and skips
without them.
"""

from concurrent.futures import ThreadPoolExecutor

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from slam_framework_tpu.optim.global_ba import GlobalBAProblem as JGBAProblem
from slam_framework_tpu.optim.pose_graph import PoseGraphProblem as JPGProblem
from slam_framework_tpu.parallel import dist_ba as jdba
from slam_framework_tpu.parallel import dist_pose_graph as jdpg
from slam_framework_tpu.parallel import map_shard as jms
from slam_framework_torch.parallel import LocalMesh, multihost
from slam_framework_torch.tools import multihost_demo as demo

LOCAL_TOL = 1e-5
REF_TOL_M = 1e-3


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs in several worker processes at once; torch's default of one
    thread per core in each of them oversubscribes the machine many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _reference(devices) -> dict:
    """The reference's sharded programs on the demo's problems over 2 devices."""
    ba = JGBAProblem(**{k: jnp.asarray(v) for k, v in demo.ba_problem().items()})
    pg = JPGProblem(**{k: jnp.asarray(v) for k, v in demo.pg_problem().items()})
    mesh = Mesh(np.array(devices[:2]), ("ba",))

    def run_ba():
        res = jdba.optimize_global_sharded(jdba.shard_problem(ba, 2), mesh, demo.K_DEMO, **demo.BA_ITERS)
        return np.asarray(res.cam_pose)

    def run_pg():
        res = jdpg.optimize_sharded(jdpg.shard_problem(pg, 2), Mesh(np.array(devices[:2]), ("pg",)), **demo.PG_ITERS)
        return np.asarray(res.v_t), np.asarray(res.v_R)

    ba_cam, (pg_t, pg_R) = run_ba(), run_pg()
    rows, mask, owner = demo.migration_case(2)
    mig_rows, mig_mask = jms.migrate_points(mesh, rows, mask, owner)
    return {"ba_cam": ba_cam, "pg_t": pg_t, "pg_R": pg_R,
            "mig_rows": np.asarray(mig_rows), "mig_mask": np.asarray(mig_mask)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory, cpu_mesh_devices):
    out = tmp_path_factory.mktemp("ranks")
    context = demo.spawn(2, "cpu", "file://" + str(out / "rendezvous"), str(out))
    # the reference compiles (mostly outside the interpreter lock) while the
    # local mesh runs and the spawned ranks start
    with ThreadPoolExecutor(1) as pool:
        ref = pool.submit(_reference, cpu_mesh_devices)
        local = demo.run_distributed(LocalMesh(2, "cpu"))
        ref = ref.result()
    return demo.collect(context, str(out), timeout_s=240.0), local, ref


@pytest.mark.parametrize("key", ["ba_cam", "ba_pt", "segba_cam", "pg_R", "pg_t", "pg_s"])
def test_gloo_ranks_agree_with_the_local_mesh(runs, key):
    ranks, local, _ = runs
    assert str(ranks["backend"]) == "gloo" and str(ranks["device"]) == "cpu"
    assert ranks[key].shape == local[key].shape
    np.testing.assert_allclose(ranks[key], local[key], rtol=0, atol=LOCAL_TOL)


def test_gloo_ranks_migrate_bit_equal_and_agree_with_the_reference(runs):
    ranks, local, ref = runs
    assert bool(ranks["migrate_ok"]) and bool(local["migrate_ok"])
    for got in (ranks, local):
        np.testing.assert_array_equal(got["mig_mask"], ref["mig_mask"])
        assert got["mig_rows"].tobytes() == ref["mig_rows"].tobytes()
    assert np.abs(ranks["ba_cam"][:, :3, 3] - ref["ba_cam"][:, :3, 3]).max() < REF_TOL_M
    assert np.abs(ranks["segba_cam"][:, :3, 3] - ref["ba_cam"][:, :3, 3]).max() < REF_TOL_M
    assert np.abs(ranks["pg_t"] - ref["pg_t"]).max() < REF_TOL_M
    assert np.abs(ranks["pg_R"] - ref["pg_R"]).max() < REF_TOL_M


def test_a_cuda_mesh_needs_one_gpu_per_rank(tmp_path):
    visible = torch.cuda.device_count() if torch.cuda.is_available() else 0
    with pytest.raises(RuntimeError, match="one GPU per rank"):
        multihost.initialize("file://" + str(tmp_path / "rendezvous"), visible + 1, 0, device="cuda")
    with pytest.raises(RuntimeError, match="not initialized"):
        multihost.ProcessMesh("cpu")


def test_with_no_device_named_the_mesh_is_on_the_card(tmp_path):
    """No device given: CUDA, never the CPU. Without a GPU that raises; with
    GPUs, one rank more than there are raises for want of a GPU."""
    visible = torch.cuda.device_count() if torch.cuda.is_available() else 0
    match = "one GPU per rank" if visible else "no CUDA device"
    with pytest.raises(RuntimeError, match=match):
        multihost.initialize("file://" + str(tmp_path / "rendezvous"), visible + 1, 0)
    assert not torch.distributed.is_initialized()


@pytest.mark.cuda
def test_nccl_ranks_on_two_gpus(tmp_path):
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip(f"needs 2 GPUs for 2 NCCL ranks; {torch.cuda.device_count()} visible")
    context = demo.spawn(2, "cuda", "file://" + str(tmp_path / "rendezvous"), str(tmp_path))
    ref = demo.single_rank(torch.device("cuda", 0))
    ranks = demo.collect(context, str(tmp_path), timeout_s=240.0)
    assert str(ranks["backend"]) == "nccl" and str(ranks["device"]) == "cuda:0" and bool(ranks["migrate_ok"])
    assert np.abs(ranks["ba_cam"][:, :3, 3] - ref["ba_cam"][:, :3, 3]).max() < REF_TOL_M
    assert np.abs(ranks["pg_t"] - ref["pg_t"]).max() < REF_TOL_M
