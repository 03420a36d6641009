"""A configuration that brings its own plain reference and its own generated
input files, as new files under ``benchmark/`` with no harness file edited
(the ``own_config`` fixture of ``conftest.py``)."""

import json
import os

import pytest

from conftest import BLOB_BYTES, run


@pytest.mark.parametrize("altered", [False, True], ids=["unaltered", "altered"])
def test_own_reference_decides_correct(own_config, altered):
    """The cell is prepared (its generated mesh written), rendered and
    checked against the configuration's own reference: a copy of plainref
    passes it, a copy whose radiance is off by 1e-3 fails it."""
    out = run(cell=own_config(altered))
    assert out["correct"] is (not altered), out["check"]
    if altered:
        assert out["check"]["pixels_off_share"]["value"] == 1.0


def test_generated_file_written_once_kept_and_refused_at_another_size(own_config):
    from harness import bench, spec
    cfg = spec.cell(own_config())["config_spec"]
    _, d = bench.prepare(cfg)
    path = os.path.join(d, "blob_gen.ply")
    assert os.path.getsize(path) == BLOB_BYTES
    first = os.stat(path)
    bench.prepare(cfg)
    again = os.stat(path)
    assert (again.st_ino, again.st_mtime_ns) == (first.st_ino, first.st_mtime_ns)
    with open(path, "rb") as f:
        written = f.read()

    wrong = json.loads(json.dumps(cfg))
    wrong["files"]["blob_gen.ply"]["bytes"] = BLOB_BYTES + 1
    with pytest.raises(RuntimeError, match="another size"):
        bench.prepare(wrong)
    with open(path, "rb") as f:
        assert f.read() == written
    assert not [f for f in os.listdir(d) if f.endswith(".tmp")]
