"""`cvad_tpu_torch.ops._build`: a library's file name hashes its source and
every ``csrc/*.cuh`` header the sources include, so a header edit rebuilds
rather than loading a stale library.  Runs on the CPU: it hashes files and
compiles nothing."""

import pytest

from cvad_tpu_torch.ops import _build


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    (tmp_path / "k.cu").write_text('#include "h.cuh"\nint k() { return 1; }\n')
    (tmp_path / "h.cuh").write_text("#pragma once\n")
    monkeypatch.setattr(_build, "CSRC_DIR", tmp_path)
    return tmp_path


@pytest.mark.parametrize("edit", ["source", "header", "new_header"])
def test_digest_changes_when_source_or_header_bytes_change(csrc, edit):
    before = _build._target("k")
    assert _build._target("k") == before  # stable for the same bytes
    if edit == "source":
        (csrc / "k.cu").write_text('#include "h.cuh"\nint k() { return 2; }\n')
    elif edit == "header":
        (csrc / "h.cuh").write_text("#pragma once\n// edited\n")
    else:
        (csrc / "g.cuh").write_text("#pragma once\n")
    after = _build._target("k")
    assert after != before
    assert after.parent == before.parent == _build.BUILD_DIR
    assert after.name.startswith("libk-") and after.suffix == ".so"


def test_the_shared_header_is_hashed_into_both_conv_libraries():
    """The port's csrc/ holds the header the two conv sources include."""
    headers = sorted(p.name for p in _build.CSRC_DIR.glob("*.cuh"))
    assert "hopper_mma.cuh" in headers
    for name in ("s2d_conv", "s2d_group_conv"):
        assert '#include "hopper_mma.cuh"' in (
            _build.CSRC_DIR / f"{name}.cu").read_text()
