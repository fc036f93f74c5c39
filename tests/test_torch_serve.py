"""The port's in-process serving engine: it serves the same answers as
the JAX package's engine for the same model, and sheds load with a
retry hint when a bucket's pool is dry."""

import numpy as np
import pytest

from repro.config import PrivacyConfig as JConfig
from repro.core.engine import PrivateTransformer as JModel
from repro.core.engine import random_weights
from repro.serve import PrivateRequest as JRequest
from repro.serve import PrivateServeEngine as JEngine
from repro_torch.config import PrivacyConfig as TConfig
from repro_torch.core.engine import PrivateTransformer as TModel
from repro_torch.core.engine import weights_from_reference
from repro_torch.serve import BundlePoolEmpty, PrivateRequest, \
    PrivateServeEngine

D, HEADS, DFF, S = 8, 2, 16, 4
PCFG = dict(he_poly_n=64, he_num_primes=2, he_t_bits=16, frac_bits=5,
            layernorm_offload=False)


@pytest.fixture(scope="module")
def engines():
    ws = random_weights(np.random.default_rng(2), D, DFF, 1)
    jm = JModel(JConfig(**PCFG), D, HEADS, DFF, ws, seed=0)
    tm = TModel(TConfig(**PCFG), D, HEADS, DFF, weights_from_reference(ws),
                seed=0, device="cpu")
    je = JEngine(jm, buckets=(S,), impl="ref")
    te = PrivateServeEngine(tm, buckets=(S,))
    xs = np.random.default_rng(4).normal(0, 1, (2, S, D))
    je.preprocess(S, 2)
    te.refill_async(S, 2).join()
    assert te.pool_size(S) == 2
    jr = je.serve([JRequest(x=x) for x in xs])
    tr = te.serve([PrivateRequest(x=x) for x in xs])
    return dict(je=je, te=te, jr=jr, tr=tr, xs=xs)


def test_engine_serves_reference_answers(engines):
    for j, t in zip(engines["jr"], engines["tr"]):
        assert t.result.shape == (S, D)
        assert np.array_equal(t.result, j.result)
    assert engines["te"].pool_size(S) == 0
    assert engines["te"].stats(S).channel_online.by_tag == \
        engines["je"].stats(S).channel_online.by_tag


def test_dry_pool_sheds_with_retry_hint(engines):
    te = engines["te"]
    with pytest.raises(BundlePoolEmpty) as exc:
        te.serve([PrivateRequest(x=engines["xs"][0])])
    assert exc.value.scope == "pool"
    assert exc.value.retry_after_s is not None and exc.value.retry_after_s > 0
    assert te.pool_size(S) == 0


def test_bad_request_returns_bundle_to_pool(engines):
    te = engines["te"]
    te.preprocess(S, 1)
    with pytest.raises(ValueError):
        te.serve([PrivateRequest(x=np.zeros((S, D + 1)))])
    assert te.pool_size(S) == 1
