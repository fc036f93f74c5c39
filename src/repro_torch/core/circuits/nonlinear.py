"""GC-friendly circuits for the transformer's nonlinear functions (§3.2).

Fixed-point format: k-bit two's complement, `frac` fractional bits
(paper §4.1: k=37 for Softmax/LayerNorm, k=21 for GeLU; frac configurable).

  * exp: i-BERT range reduction — x ≤ 0, q = ⌊x / ln2⌋ via constant
    multiply, r = x − q·ln2 ∈ (−ln2, 0], 2nd-order i-BERT polynomial
    0.3585(r + 1.353)² + 0.344, then a barrel right-shift by q.
  * softmax row: max-tree → subtract → exp → sum-tree → Newton–Raphson
    reciprocal → per-element multiply.
  * GeLU: clip to (−4, 4) then 16-segment piecewise-linear LUT
    (mux tree over constant tables folds to XOR-only leaf levels).
  * LayerNorm FULL (baseline protocol): mean, variance, rsqrt (NR in
    fixed point), normalize, γ/β affine.
  * LayerNorm REDUCED Ĉ₂ (APINT protocol): mean/variance/γ/β are computed
    outside GC (shares + HE); the circuit only does rsqrt(var) and the
    per-element multiply — the paper's Fig. 4 workload reallocation.

Every multiplication routes through ``arith.mul`` so the XFBQ/conventional
choice (PrivacyConfig.mult_style) applies globally.
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

from repro_torch.core.circuits import arith
from repro_torch.core.circuits.builder import CircuitBuilder, Word

LN2 = math.log(2.0)


def _fx(value: float, frac: int, k: int) -> int:
    return int(round(value * (1 << frac))) % (1 << k)


# ---------------------------------------------------------------------------
# exp (i-BERT) — input x <= 0
# ---------------------------------------------------------------------------


def exp_circuit(cb: CircuitBuilder, x: Word, frac: int, style: str,
                max_shift_bits: int = 5) -> Word:
    """exp(x) for x ∈ (−2^(k-frac-1), 0]; result in (0, 1]."""
    k = len(x)
    # i-BERT convention: q = ⌊−x/ln2⌋ ≥ 0, r = x + q·ln2 ∈ (−ln2, 0],
    # exp(x) = exp(r) · 2^(−q). The q product is formed in a widened word so
    # it cannot wrap; arithmetic shift by 2·frac is exact floor division.
    kw = k + frac + 2
    nxw = arith.sign_extend(cb, arith.neg(cb, x), kw)
    z = arith.mul_const(cb, nxw, _fx(1.0 / LN2, frac, kw), width=kw)
    qw = arith.shift_right_const(cb, z, 2 * frac, arithmetic=True)  # int ≥ 0
    q = Word(qw.bits[:k])
    qln2 = arith.mul_const(cb, q, _fx(LN2, frac, k))  # scale frac
    r = arith.add(cb, x, qln2)  # ∈ (−ln2, 0]
    # i-BERT: exp(r) ≈ 0.3585 (r + 1.353)^2 + 0.344 on (−ln2, 0]
    t = arith.add_const(cb, r, _fx(1.353, frac, k))
    t2 = arith.fx_mul(cb, t, t, frac, style=style)
    p = arith.mul_const(cb, t2, _fx(0.3585, frac, k))
    p = arith.shift_right_const(cb, p, frac, arithmetic=True)
    p = arith.add_const(cb, p, _fx(0.344, frac, k))
    # shift right by q: amount = min(q, 2^max_shift_bits − 1)
    amount = Word(q.bits[:max_shift_bits])
    # saturate: if q >= 2^max_shift_bits, result ~ 0 — detect high bits set
    high = cb.constant(0)
    for b in q.bits[max_shift_bits:k - 1]:
        high = cb.OR(high, b)
    shifted = arith.shift_right_var(cb, p, amount, arithmetic=False)
    zero = cb.const_word(0, k)
    return arith.mux(cb, high, zero, shifted)


# ---------------------------------------------------------------------------
# reciprocal / rsqrt via Newton–Raphson with LZC normalization
# ---------------------------------------------------------------------------


def _leading_one_onehot(cb: CircuitBuilder, x: Word) -> List[int]:
    """One-hot of the most significant set bit (MSB-first scan)."""
    k = len(x)
    none_yet = cb.constant(1)
    onehot = [cb.constant(0)] * k
    for i in reversed(range(k)):
        hit = cb.AND(none_yet, x[i])
        onehot[i] = hit
        none_yet = cb.AND(none_yet, cb.INV(x[i]))
    return onehot


def reciprocal_circuit(cb: CircuitBuilder, x: Word, frac: int, style: str,
                       iters: int = 3) -> Word:
    """1/x for x > 0, fixed point. Normalize x ∈ [0.5, 1) by LZC shift,
    NR iterate y ← y(2 − xy), denormalize."""
    k = len(x)
    onehot = _leading_one_onehot(cb, x)
    # normalized m = x·2^sh with leading one at frac−1 → m ∈ [0.5, 1):
    # build by mux-summing shifted copies against the one-hot (XOR-combine,
    # rows are disjoint).
    m_bits = [cb.constant(0)] * k
    e_onehot: List[Tuple[int, int]] = []  # (shift_amount_signed, sel)
    for pos in range(k):
        sel = onehot[pos]
        sh = (frac - 1) - pos  # leading one lands at frac−1 → m ∈ [0.5, 1)
        if sh >= 0:
            row = arith.shift_left_const(cb, x, sh)
        else:
            row = arith.shift_right_const(cb, x, -sh)
        for i in range(k):
            m_bits[i] = cb.XOR(m_bits[i], cb.AND(sel, row[i]))
        e_onehot.append((sh, sel))
    m = Word(tuple(m_bits))
    # initial guess y0 = 48/17 − 32/17·m  (standard NR seed for [0.5, 1))
    y = arith.sub(
        cb,
        cb.const_word(_fx(48.0 / 17.0, frac, k), k),
        arith.shift_right_const(
            cb, arith.mul_const(cb, m, _fx(32.0 / 17.0, frac, k)), frac,
            arithmetic=True,
        ),
    )
    two = cb.const_word(_fx(2.0, frac, k), k)
    for _ in range(iters):
        xy = arith.fx_mul(cb, m, y, frac, style=style)
        y = arith.fx_mul(cb, y, arith.sub(cb, two, xy), frac, style=style)
    # denormalize: 1/x = y * 2^(sh) where m = x·2^sh / 2^frac
    out_bits = [cb.constant(0)] * k
    for sh, sel in e_onehot:
        if sh >= 0:
            row = arith.shift_left_const(cb, y, sh)
        else:
            row = arith.shift_right_const(cb, y, -sh)
        for i in range(k):
            out_bits[i] = cb.XOR(out_bits[i], cb.AND(sel, row[i]))
    return Word(tuple(out_bits))


def rsqrt_circuit(cb: CircuitBuilder, x: Word, frac: int, style: str,
                  iters: int = 3) -> Word:
    """1/sqrt(x) for x > 0: normalize to [1,4), NR y ← y(3 − x y²)/2."""
    k = len(x)
    onehot = _leading_one_onehot(cb, x)
    # pair positions so the exponent shift is even: leading bit at frac or
    # frac+1 -> m ∈ [1, 4)
    m_bits = [cb.constant(0)] * k
    rows: List[Tuple[int, int]] = []
    for pos in range(k):
        sel = onehot[pos]
        sh = frac - pos
        sh_even = sh if sh % 2 == 0 else sh + 1  # keep parity even
        if sh_even >= 0:
            row = arith.shift_left_const(cb, x, sh_even)
        else:
            row = arith.shift_right_const(cb, x, -sh_even)
        for i in range(k):
            m_bits[i] = cb.XOR(m_bits[i], cb.AND(sel, row[i]))
        rows.append((sh_even, sel))
    m = Word(tuple(m_bits))
    # seed y0 ≈ 1.12 − 0.17·m (stays positive on all of [1,4); NR basin)
    y = arith.sub(
        cb,
        cb.const_word(_fx(1.12, frac, k), k),
        arith.shift_right_const(
            cb, arith.mul_const(cb, m, _fx(0.17, frac, k)), frac,
            arithmetic=True,
        ),
    )
    three = cb.const_word(_fx(3.0, frac, k), k)
    for _ in range(iters):
        y2 = arith.fx_mul(cb, y, y, frac, style=style)
        xy2 = arith.fx_mul(cb, m, y2, frac, style=style)
        y = arith.fx_mul(cb, y, arith.sub(cb, three, xy2), frac, style=style)
        y = arith.shift_right_const(cb, y, 1, arithmetic=True)
    # denormalize: 1/sqrt(x) = y · 2^(sh/2)
    out_bits = [cb.constant(0)] * k
    for sh_even, sel in rows:
        h = sh_even // 2
        if h >= 0:
            row = arith.shift_left_const(cb, y, h)
        else:
            row = arith.shift_right_const(cb, y, -h)
        for i in range(k):
            out_bits[i] = cb.XOR(out_bits[i], cb.AND(sel, row[i]))
    return Word(tuple(out_bits))


# ---------------------------------------------------------------------------
# softmax row
# ---------------------------------------------------------------------------


def softmax_circuit(n: int, k: int = 37, frac: int = 12, style: str = "xfbq",
                    inputs: str = "e") -> CircuitBuilder:
    """Softmax over an n-element row; all inputs are evaluator words
    (the shares sum x = <x> is reconstructed by a free XOR-add outside;
    here the row arrives as cleartext-in-labels, as in the protocol)."""
    cb = CircuitBuilder(f"softmax{n}_{k}b")
    xs = [
        (cb.e_input_word(k) if inputs == "e" else cb.g_input_word(k))
        for _ in range(n)
    ]
    # max tree
    mx = xs[0]
    for w in xs[1:]:
        mx = arith.max_word(cb, mx, w)
    es = []
    for w in xs:
        d = arith.sub(cb, w, mx)  # <= 0
        es.append(exp_circuit(cb, d, frac, style))
    s = es[0]
    for w in es[1:]:
        s = arith.add(cb, s, w)
    inv = reciprocal_circuit(cb, s, frac, style)
    for w in es:
        cb.output(arith.fx_mul(cb, w, inv, frac, style=style))
    return cb


# ---------------------------------------------------------------------------
# GeLU via clipping + LUT interpolation
# ---------------------------------------------------------------------------


def _gelu(v: float) -> float:
    return 0.5 * v * (1.0 + math.erf(v / math.sqrt(2.0)))


def gelu_circuit(k: int = 21, frac: int = 10, style: str = "xfbq",
                 segments: int = 16) -> CircuitBuilder:
    """GeLU(x): clip x to (−4, 4) [7], piecewise-linear over `segments`."""
    cb = CircuitBuilder(f"gelu_{k}b")
    x = cb.e_input_word(k)
    lo = cb.const_word(_fx(-4.0, frac, k), k)
    hi = cb.const_word(_fx(4.0, frac, k) - 1, k)  # 4 − ulp keeps idx in range
    x_lt_lo = arith.lt_signed(cb, x, lo)
    hi_lt_x = arith.lt_signed(cb, hi, x)
    xc = arith.mux(cb, x_lt_lo, lo, x)
    xc = arith.mux(cb, hi_lt_x, hi, xc)
    # segment index from the top bits of (xc + 4) ∈ [0, 8)
    xs = arith.add_const(cb, xc, _fx(4.0, frac, k))
    seg_bits = int(math.log2(segments))
    # xs in [0, 8): integer part is 3 bits above frac; take seg_bits msbs of
    # the [0,8) range: bits [frac+3-seg_bits, frac+3)
    lo_bit = frac + 3 - seg_bits
    idx = Word(tuple(xs[lo_bit + i] for i in range(seg_bits)))
    # constant tables
    width = 8.0 / segments
    slopes, intercepts = [], []
    for s in range(segments):
        a = -4.0 + s * width
        b = a + width
        ga, gb = _gelu(a), _gelu(b)
        m = (gb - ga) / width
        c = ga - m * a
        slopes.append(_fx(m, frac, k))
        intercepts.append(_fx(c, frac, k))
    # mux trees over constants (leaf levels fold to XORs)
    def lut(table: List[int]) -> Word:
        words = [cb.const_word(v, k) for v in table]
        level = words
        for bit in idx:
            nxt = []
            for i in range(0, len(level), 2):
                nxt.append(arith.mux(cb, bit, level[i + 1], level[i]))
            level = nxt
        return level[0]

    m_w = lut(slopes)
    c_w = lut(intercepts)
    y = arith.fx_mul(cb, xc, m_w, frac, style=style)
    y = arith.add(cb, y, c_w)
    cb.output(y)
    return cb


def silu_circuit(k: int = 21, frac: int = 10, style: str = "xfbq",
                 segments: int = 16) -> CircuitBuilder:
    """SiLU(x) = x·σ(x), same clip+LUT recipe (llama-family activation)."""
    cb = CircuitBuilder(f"silu_{k}b")
    x = cb.e_input_word(k)
    lo = cb.const_word(_fx(-6.0, frac, k), k)
    hi = cb.const_word(_fx(6.0, frac, k) - 1, k)
    x_lt_lo = arith.lt_signed(cb, x, lo)
    hi_lt_x = arith.lt_signed(cb, hi, x)
    xc = arith.mux(cb, x_lt_lo, lo, x)
    xc = arith.mux(cb, hi_lt_x, hi, xc)
    xs = arith.add_const(cb, xc, _fx(6.0, frac, k))
    seg_bits = int(math.log2(segments))
    rng = 12.0
    int_bits = 4  # [0, 16) covers [0,12]
    lo_bit = frac + int_bits - seg_bits
    idx = Word(tuple(xs[lo_bit + i] for i in range(seg_bits)))
    width = 16.0 / segments

    def f(v: float) -> float:
        return v / (1.0 + math.exp(-v))

    slopes, intercepts = [], []
    for s in range(segments):
        a = -6.0 + s * width
        b = min(a + width, 6.0)
        fa, fb = f(a), f(b)
        m = (fb - fa) / (b - a) if b > a else 0.0
        c = fa - m * a
        slopes.append(_fx(m, frac, k))
        intercepts.append(_fx(c, frac, k))

    def lut(table):
        level = [cb.const_word(v, k) for v in table]
        for bit in idx:
            nxt = []
            for i in range(0, len(level), 2):
                nxt.append(arith.mux(cb, bit, level[i + 1], level[i]))
            level = nxt
        return level[0]

    y = arith.fx_mul(cb, xc, lut(slopes), frac, style=style)
    y = arith.add(cb, y, lut(intercepts))
    cb.output(y)
    return cb


# ---------------------------------------------------------------------------
# LayerNorm: full C2 (baseline) vs reduced Ĉ2 (APINT)
# ---------------------------------------------------------------------------


def layernorm_full_circuit(n: int, k: int = 37, frac: int = 12,
                           style: str = "xfbq") -> CircuitBuilder:
    """Conventional LayerNorm entirely in GC (the PRIMER-baseline workload):
    mean, variance, rsqrt, normalize, γ/β affine. n must be a power of 2."""
    assert n & (n - 1) == 0
    cb = CircuitBuilder(f"layernorm_full{n}_{k}b")
    xs = [cb.e_input_word(k) for _ in range(n)]
    gammas = [cb.g_input_word(k) for _ in range(n)]
    betas = [cb.g_input_word(k) for _ in range(n)]
    s = xs[0]
    for w in xs[1:]:
        s = arith.add(cb, s, w)
    mean = arith.shift_right_const(cb, s, int(math.log2(n)), arithmetic=True)
    cs = [arith.sub(cb, w, mean) for w in xs]
    sq = [arith.fx_mul(cb, c, c, frac, style=style) for c in cs]
    v = sq[0]
    for w in sq[1:]:
        v = arith.add(cb, v, w)
    var = arith.shift_right_const(cb, v, int(math.log2(n)), arithmetic=True)
    var = arith.add_const(cb, var, 1)  # + eps (1 ulp)
    rs = rsqrt_circuit(cb, var, frac, style)
    for c, g, b in zip(cs, gammas, betas):
        yn = arith.fx_mul(cb, c, rs, frac, style=style)
        yg = arith.fx_mul(cb, yn, g, frac, style=style)
        cb.output(arith.add(cb, yg, b))
    return cb


def layernorm_reduced_circuit(n: int, k: int = 37, frac: int = 12,
                              style: str = "xfbq") -> CircuitBuilder:
    """APINT Ĉ₂ (Fig. 4 ⑦–⑫): mean/variance/γ·x/β live *outside* GC.

    Inputs: centered elements x'_i (evaluator, from standard ops on shares)
    and the variance (computed via the HE-assisted identity ⑧–⑨). The
    circuit does rsqrt + per-element multiply only.
    """
    cb = CircuitBuilder(f"layernorm_reduced{n}_{k}b")
    cs = [cb.e_input_word(k) for _ in range(n)]
    var = cb.e_input_word(k)
    var = arith.add_const(cb, var, 1)
    rs = rsqrt_circuit(cb, var, frac, style)
    for c in cs:
        cb.output(arith.fx_mul(cb, c, rs, frac, style=style))
    return cb
