"""The port's compile → preprocess → run against the JAX package's, for
the same seed and the same weights: revealed outputs bit-identical and
per-tag offline/online ledgers equal, with the LayerNorm offload on and
off and the channel meter on wire v1 and v2.

The JAX session garbles through its host oracle (``impl="ref"``): garbled
circuits compute their netlists exactly, so what a session reveals does
not depend on the walk, and the executor itself is held to the JAX
executor in ``test_torch_gc_exec.py``."""

import numpy as np
import pytest

from repro.config import PrivacyConfig as JConfig
from repro.core.engine import PrivateTransformer as JModel
from repro.core.engine import random_weights
from repro_torch.config import PrivacyConfig as TConfig
from repro_torch.core.engine import PrivateTransformer as TModel
from repro_torch.core.engine import weights_from_reference
from repro.core.session import GarblingCache as JCache
from repro_torch.core.session import BundleExhausted, GarblingCache

D, HEADS, DFF, S = 8, 2, 16, 4
# small share modulus: the same circuits as the defaults, narrower words
PCFG = dict(he_poly_n=64, he_num_primes=2, he_t_bits=16, frac_bits=5)
CASES = [(True, 1), (False, 1), (False, 2)]  # (layernorm_offload, wire)
IDS = [f"offload={o}-v{w}" for o, w in CASES]


def _models(offload):
    ws = random_weights(np.random.default_rng(0), D, DFF, 1)
    jm = JModel(JConfig(**PCFG, layernorm_offload=offload), D, HEADS, DFF,
                ws, seed=0)
    tm = TModel(TConfig(**PCFG, layernorm_offload=offload), D, HEADS, DFF,
                weights_from_reference(ws), seed=0, device="cpu")
    return jm, tm


def _serve(model, wire, **kw):
    sess = model.compile_session(S, seed=3, wire_version=wire, **kw)
    bundles = sess.preprocess(2)
    x = np.random.default_rng(1).normal(0, 1, (S, D))
    y = sess.run(x, bundles[0])
    return dict(sess=sess, bundles=bundles, x=x, y=y,
                snap=sess.stats.comm_snapshot(), stats=sess.stats)


@pytest.fixture(scope="module", params=CASES, ids=IDS)
def pair(request):
    offload, wire = request.param
    jm, tm = _models(offload)
    return _serve(jm, wire, impl="ref"), _serve(tm, wire)


def test_outputs_bit_identical(pair):
    j, t = pair
    assert t["y"].dtype == j["y"].dtype and t["y"].shape == (S, D)
    assert np.array_equal(t["y"], j["y"])


@pytest.mark.parametrize("phase", ["offline", "online"])
def test_ledgers_equal(pair, phase):
    j, t = pair
    assert t["snap"][phase] == j["snap"][phase]
    assert t["snap"][phase]["by_tag"]


def test_gc_work_counters_equal(pair):
    j, t = pair
    for f in ("gc_and_gates", "gc_gates", "gc_instances_gates",
              "gc_instances_ands", "he_pt_muls", "he_encrypts"):
        assert getattr(t["stats"], f) == getattr(j["stats"], f), f
    assert t["stats"].per_fn == j["stats"].per_fn


def test_bundles_are_single_use(pair):
    _, t = pair
    with pytest.raises(BundleExhausted):
        t["sess"].run(t["x"], t["bundles"][0])


def test_garbling_cache_resolves_reference_slabs(pair):
    j, t = pair
    jc, tc = JCache(j["sess"].protocol), GarblingCache(t["sess"].protocol)
    jn, jr = jc.distinct_nets(j["sess"].plan, n=2)
    tn, tr = tc.distinct_nets(t["sess"].plan, n=2)
    assert list(tn) == list(jn) and tr == jr
    assert all(tn[k].and_count == jn[k].and_count for k in tn)
    tc.distinct_nets(t["sess"].plan, n=2)
    assert (tc.misses, tc.hits) == (len(tn), len(tn))
    assert tc.distinct_netlists == len(tn)
