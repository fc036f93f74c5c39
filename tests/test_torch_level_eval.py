"""The level kernels' wrappers: the plain PyTorch path against the JAX
package's jnp reference and its Pallas kernels (interpret mode), bit for
bit, over all four ops and a ragged G; the argument checks; no build
without nvcc. The CUDA kernels themselves are held to the plain path in
``test_torch_cuda.py``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.level_eval import ref as LJ
from repro.kernels.level_eval.level_eval import (
    eval_level_pallas,
    garble_level_pallas,
)
from repro_torch.kernels import build
from repro_torch.kernels.level_eval import level_eval as LE
from repro_torch.kernels.level_eval import ref as LT

G = 3001  # not a multiple of the Pallas block (2048)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x).view(np.int32))


def _u(x):
    return x.cpu().numpy().view(np.uint32)


@pytest.fixture(scope="module")
def level():
    rng = np.random.default_rng(11)
    ops = np.repeat(np.arange(4, dtype=np.uint32), -(-G // 4))[:G]
    rng.shuffle(ops)
    a, b, tg, te = (rng.integers(0, 1 << 32, (G, 4), dtype=np.uint32)
                    for _ in range(4))
    r = np.broadcast_to(
        rng.integers(0, 1 << 32, (1, 4), dtype=np.uint32) | 1, (G, 4)).copy()
    tw = rng.integers(0, 1 << 32, (G,), dtype=np.uint32)
    return dict(ops=ops, a=a, b=b, tg=tg, te=te, r=r, tw=tw)


def _eval_args(v):
    return (v["ops"], v["a"], v["b"], v["tg"], v["te"], v["tw"])


def _garble_args(v):
    return (v["ops"], v["a"], v["b"], v["r"], v["tw"])


@pytest.mark.parametrize("oracle", ["ref", "pallas_interpret"])
def test_eval_level_matches_reference(level, oracle):
    args = _eval_args(level)
    LE.reset_launches()
    got = LE.eval_level(*(_t(x) for x in args))
    jargs = [jnp.asarray(x) for x in args]
    want = (LJ.eval_level(*jargs) if oracle == "ref"
            else eval_level_pallas(*jargs, interpret=True))
    assert np.array_equal(_u(got), np.asarray(want))
    assert set(np.unique(level["ops"])) == {0, 1, 2, 3}
    assert LE.eval_level.launches == 0  # CPU tensors: the plain path


@pytest.mark.parametrize("oracle", ["ref", "pallas_interpret"])
def test_garble_level_matches_reference(level, oracle):
    args = _garble_args(level)
    LE.reset_launches()
    got = LE.garble_level(*(_t(x) for x in args))
    jargs = [jnp.asarray(x) for x in args]
    want = (LJ.garble_level(*jargs) if oracle == "ref"
            else garble_level_pallas(*jargs, interpret=True))
    for g, w in zip(got, want):
        assert np.array_equal(_u(g), np.asarray(w))
    assert LE.garble_level.launches == 0


def test_garble_level_writes_into_out(level):
    args = [_t(x) for x in _garble_args(level)]
    out = tuple(torch.empty((G, 4), dtype=torch.int32) for _ in range(3))
    res = LE.garble_level(*args, out=out)
    assert all(x is y for x, y in zip(res, out))
    for g, w in zip(out, LT.garble_level(*args)):
        assert torch.equal(g, w)


@pytest.mark.parametrize("bad", ["dtype", "shape", "contiguity", "device"])
def test_wrapper_rejects_bad_operands(level, bad):
    args = [_t(x) for x in _eval_args(level)]
    if bad == "dtype":
        args[1] = args[1].to(torch.int64)
    elif bad == "shape":
        args[5] = args[5][:-1]
    elif bad == "contiguity":
        args[2] = args[2].t().contiguous().t()
    else:
        args[3] = args[3].to("meta")
    with pytest.raises((TypeError, ValueError)):
        LE.eval_level(*args)


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    """No toolkit, no library: the wrappers' CUDA path has nothing to fall
    back to, so the build raises."""
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setenv("REPRO_TORCH_BUILD_DIR", str(tmp_path / "build"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.build([LE.SOURCE])
    assert not list((tmp_path / "build").glob("*.so"))
