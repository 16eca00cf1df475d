"""The "fleet_node" rule (``DEFAULT_RULES``): the detector's node axis is
not sharded, and a mesh moves no verdict.

The rule's one user in the reference is the constraint its jnp scorer
puts on the node axis (``repro/kernels/fleet_score/ops.py``, backend
"jax"); the Pallas kernel never shards. The port's detector has only K1's
path and reads no mesh: a node-sharded K1 would need its radix select to
sum each pass's counts across the ranks, a kernel change, and one card
scores 131,072 nodes in well under a millisecond. So under an (n, 1)
("data", "model") CPU mesh (a gloo group of this process, n = 1) the
port's verdicts equal its verdicts without one, and both equal the
reference's "jax" backend run under the reference's CPU mesh, window by
window, on the golden sequences.
"""
import copy

import jax
import pytest
import torch.distributed as tdist

from repro.core import DetectorConfig as RefConfig
from repro.core import StragglerDetector as RefDetector
from repro.dist import api as jax_dist
from repro.launch import mesh as jax_mesh
from repro_torch.core import DetectorConfig, StragglerDetector
from repro_torch.dist import api as dist
from repro_torch.launch import mesh as launch_mesh
from test_detector_golden import scripted_sequence, simulated_sequence
from test_torch_detector import assert_same_window, port_frame


@pytest.fixture
def one_rank_group(tmp_path):
    tdist.init_process_group("gloo", store=tdist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        yield
    finally:
        tdist.destroy_process_group()


def _port_windows(frames, mesh=None):
    det = StragglerDetector(DetectorConfig(device="cpu"))
    out = []
    for f in frames:
        if mesh is None:
            out.append(det.update(port_frame(f)))
        else:
            with dist.use_mesh(mesh):
                out.append(det.update(port_frame(f)))
    return out


def _reference_windows(frames):
    det = RefDetector(RefConfig(scorer="jax"))
    mesh = jax_mesh.make_cpu_mesh()
    with mesh, jax_dist.use_mesh(mesh):
        return [det.update(copy.deepcopy(f)) for f in frames]


@pytest.mark.parametrize("sequence", [scripted_sequence, simulated_sequence])
def test_verdicts_do_not_move_under_a_node_mesh(one_rank_group, sequence):
    frames = sequence()
    mesh = launch_mesh.make_cpu_mesh()
    assert dict(zip(mesh.mesh_dim_names, mesh.shape)) == \
        {"data": tdist.get_world_size(), "model": 1}
    with dist.use_mesh(mesh) as ctx:
        assert ctx.mesh_axes("fleet_node") == ("data",)
    plain = _port_windows(frames)
    meshed = _port_windows(frames, mesh)
    ref = _reference_windows(frames)
    assert len(jax.devices()) == tdist.get_world_size()
    for w, (a, b, c) in enumerate(zip(ref, plain, meshed)):
        assert_same_window(a, b, w)
        assert_same_window(a, c, w)
