"""The port's compressed (pod-manual, int8 error-feedback) mesh step on
DeepSeek (reduced, top-2 of 8 experts) held to the reference's on (pod 2,
data 2, model 2), as ``test_torch_mesh_train.py`` holds minitron's: each
pod's gradient from its own half of the batch, microbatches cut inside
the pod, the codes moving by one where a gradient's last bits differ,
and each pod's own error-feedback buffer against the reference pod's.
"""
import numpy as np
import pytest

from repro_torch.distributed.sharding import set_activation_mesh
from test_torch_mesh_train import _flat, _tree, hold_steps, one_torch_thread  # noqa: F401


@pytest.fixture(autouse=True)
def no_activation_mesh():
    yield
    set_activation_mesh(None)


def test_deepseek_compressed_mesh_step_matches_the_reference(tmp_path):
    ref = hold_steps(tmp_path, "deepseek-v2-lite-16b", 2, 0, "compressed")
    for k, e0 in _flat(_tree(ref, "compressed/s0/ef0")):
        assert np.array_equal(e0, ref[f"compressed/s0/ef_host{k}"])
