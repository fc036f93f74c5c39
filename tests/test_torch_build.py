"""The kernel build's digest covers every file a source includes: a
source whose shared header changed gets a new library name (and so a
rebuild). Needs no nvcc: only the digest is computed."""

from pathlib import Path

import pytest

from repro_torch.kernels import build
from repro_torch.kernels.halfgate import halfgate as HG
from repro_torch.kernels.label_select import label_select as LS
from repro_torch.kernels.level_eval import level_eval as LE
from repro_torch.kernels.ntt import ntt as NTT

SHARED = build.INCLUDE_DIR / "halfgate.cuh"


def test_sources_depend_on_the_shared_header():
    for src in (LE.SOURCE, HG.SOURCE):
        deps = build.dependencies(src)
        assert deps[0] == src and SHARED in deps, deps
    for src in (NTT.SOURCE, LS.SOURCE):
        assert build.dependencies(src) == [src]


def test_digest_follows_an_included_header(tmp_path, monkeypatch):
    shared = tmp_path / "shared"
    shared.mkdir()
    header = shared / "cipher.cuh"
    header.write_text("#pragma once\nconstexpr int kRounds = 8;\n")
    (shared / "unrelated.cuh").write_text("// not included\n")
    pkg = tmp_path / "pkg" / "csrc"
    pkg.mkdir(parents=True)
    local = pkg / "local.cuh"
    local.write_text('#include "cipher.cuh"\n')
    src = pkg / "kernel.cu"
    src.write_text('#include <stdint.h>\n#include "local.cuh"\n')
    monkeypatch.setattr(build, "INCLUDE_DIR", shared)
    monkeypatch.setenv("REPRO_TORCH_BUILD_DIR", str(tmp_path / "out"))

    assert build.dependencies(src) == [src, local, header]
    first = build._target(src)
    assert first.parent == tmp_path / "out" and first.name.startswith("kernel-")
    (shared / "unrelated.cuh").write_text("// edited, still not included\n")
    assert build._target(src) == first
    header.write_text("#pragma once\nconstexpr int kRounds = 9;\n")
    second = build._target(src)
    assert second != first
    local.write_text('#include "cipher.cuh"\n// edited\n')
    assert build._target(src) not in (first, second)


def test_missing_include_is_an_error(tmp_path, monkeypatch):
    monkeypatch.setattr(build, "INCLUDE_DIR", tmp_path)
    src = tmp_path / "k.cu"
    src.write_text('#include "nowhere.cuh"\n')
    with pytest.raises(FileNotFoundError, match="nowhere.cuh"):
        build.dependencies(src)


def test_level_eval_build_name_is_stable():
    assert build._target(LE.SOURCE) == build._target(Path(str(LE.SOURCE)))
    assert build._target(LE.SOURCE).name.startswith("level_eval-")
