"""Twin of ``tests/test_data_pipeline.py:52`` on the port: the data
expansion of ``repro_torch.data.expansion_table`` grows with resolution and
observation history, to the paper's Fig. 1 magnitude. A file of its own
because it is the slowest data-plane twin (as its reference is), so
``--dist loadfile`` does not queue it behind other slow files. Imports
neither jax nor msgpack.
"""
import pytest

pytest.importorskip("torch")

from repro_torch.data import expansion_table  # noqa: E402


def test_expansion_grows_with_resolution_and_history():
    rows = expansion_table(kinds=("video",), resolutions=(224, 640),
                           histories=(1, 4), n=8)
    by = {(r["resolution"], r["history"]): r["expansion_mean"] for r in rows}
    assert by[(640, 1)] > by[(224, 1)]
    assert by[(640, 4)] > by[(640, 1)]
    # paper Fig. 1 magnitude: hundreds-to-thousands x at max config
    assert by[(640, 4)] > 100
