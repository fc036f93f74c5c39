"""Fixed-point arithmetic circuits over ``Word`` bit-vectors.

AND-gate budgets (the GC cost unit — XOR/INV are free):

  * full adder: 1 AND/bit (carry = ((a^c)&(b^c))^c — MAJ identity)
  * mux: 1 AND/bit
  * conventional k×k multiply: k² partial-product ANDs + (k-1)·k adder ANDs
  * XFBQ multiply (§3.2, [12]): partial products become XNORs (free under
    FreeXOR); only the adder tree pays ANDs, plus optional Q-error
    correction terms (a conditional add per operand LSB).

All words are little-endian two's-complement; arithmetic wraps mod 2^k.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from repro_torch.core.circuits.builder import CircuitBuilder, Word


# ---------------------------------------------------------------------------
# addition / subtraction
# ---------------------------------------------------------------------------


def add(cb: CircuitBuilder, a: Word, b: Word, cin: Optional[int] = None,
        width: Optional[int] = None) -> Word:
    """a + b (+cin) mod 2^width; width defaults to len(a)."""
    k = width or len(a)
    c = cin if cin is not None else cb.constant(0)
    out: List[int] = []
    for i in range(k):
        ai = a[i] if i < len(a) else cb.constant(0)
        bi = b[i] if i < len(b) else cb.constant(0)
        axc = cb.XOR(ai, c)
        bxc = cb.XOR(bi, c)
        out.append(cb.XOR(axc, bi))
        if i + 1 < k:  # final carry unused
            c = cb.XOR(cb.AND(axc, bxc), c)
    return Word(tuple(out))


def invert(cb: CircuitBuilder, a: Word) -> Word:
    return Word(tuple(cb.INV(x) for x in a))


def sign_extend(cb: CircuitBuilder, a: Word, new_k: int) -> Word:
    """Free: replicate the sign bit."""
    if new_k <= len(a):
        return Word(a.bits[:new_k])
    return Word(a.bits + tuple(a[-1] for _ in range(new_k - len(a))))


def sub(cb: CircuitBuilder, a: Word, b: Word) -> Word:
    return add(cb, a, invert(cb, b), cin=cb.constant(1))


def neg(cb: CircuitBuilder, a: Word) -> Word:
    zero = cb.const_word(0, len(a))
    return sub(cb, zero, a)


def add_const(cb: CircuitBuilder, a: Word, value: int) -> Word:
    return add(cb, a, cb.const_word(value, len(a)))


# ---------------------------------------------------------------------------
# select / compare / shift
# ---------------------------------------------------------------------------


def mux(cb: CircuitBuilder, sel: int, a: Word, b: Word) -> Word:
    """sel ? a : b."""
    return Word(tuple(cb.MUX(sel, x, y) for x, y in zip(a, b)))


def lt_unsigned(cb: CircuitBuilder, a: Word, b: Word) -> int:
    """1 if a < b (unsigned): borrow chain, 1 AND/bit."""
    # borrow_{i+1} = (~a_i & b_i) | (borrow_i & ~(a_i ^ b_i))
    #             = ((a_i ^ borrow) & (b_i ^ borrow)) ^ borrow with a inverted trick:
    borrow = cb.constant(0)
    for ai, bi in zip(a, b):
        na = cb.INV(ai)
        axc = cb.XOR(na, borrow)
        bxc = cb.XOR(bi, borrow)
        borrow = cb.XOR(cb.AND(axc, bxc), borrow)
    return borrow


def lt_signed(cb: CircuitBuilder, a: Word, b: Word) -> int:
    d = sub(cb, a, b)
    # overflow-aware sign: (a-b)_msb ^ overflow; for |values| << 2^(k-1) the
    # plain msb suffices — inputs are range-limited by the fixed-point format.
    return d[-1]


def eq(cb: CircuitBuilder, a: Word, b: Word) -> int:
    acc = cb.constant(1)
    for ai, bi in zip(a, b):
        acc = cb.AND(acc, cb.INV(cb.XOR(ai, bi)))
    return acc


def max_word(cb: CircuitBuilder, a: Word, b: Word, signed=True) -> Word:
    s = lt_signed(cb, a, b) if signed else lt_unsigned(cb, a, b)
    return mux(cb, s, b, a)


def shift_left_const(cb: CircuitBuilder, a: Word, n: int) -> Word:
    k = len(a)
    zeros = tuple(cb.constant(0) for _ in range(min(n, k)))
    return Word((zeros + a.bits)[:k])


def shift_right_const(cb: CircuitBuilder, a: Word, n: int, arithmetic=False) -> Word:
    k = len(a)
    fill = a[-1] if arithmetic else cb.constant(0)
    bits = a.bits[n:] + tuple(fill for _ in range(min(n, k)))
    return Word(bits[:k])


def shift_right_var(cb: CircuitBuilder, a: Word, amount: Word, arithmetic=False) -> Word:
    """Barrel shifter: log2 stages of muxes; amount little-endian."""
    cur = a
    for s, sel in enumerate(amount):
        shifted = shift_right_const(cb, cur, 1 << s, arithmetic)
        cur = mux(cb, sel, shifted, cur)
    return cur


def shift_left_var(cb: CircuitBuilder, a: Word, amount: Word) -> Word:
    cur = a
    for s, sel in enumerate(amount):
        shifted = shift_left_const(cb, cur, 1 << s)
        cur = mux(cb, sel, shifted, cur)
    return cur


# ---------------------------------------------------------------------------
# multiplication
# ---------------------------------------------------------------------------


def _sum_tree(cb: CircuitBuilder, words: List[Word], width: int) -> Word:
    """Balanced binary adder tree."""
    assert words
    cur = list(words)
    while len(cur) > 1:
        nxt = []
        for i in range(0, len(cur) - 1, 2):
            nxt.append(add(cb, cur[i], cur[i + 1], width=width))
        if len(cur) % 2:
            nxt.append(cur[-1])
        cur = nxt
    return cur[0]


def mul_conventional(cb: CircuitBuilder, a: Word, b: Word,
                     width: Optional[int] = None) -> Word:
    """Schoolbook multiply mod 2^width: k² AND partial products + adder tree."""
    k = width or len(a)
    pps: List[Word] = []
    for j in range(min(len(b), k)):
        row = [cb.constant(0)] * j
        for i in range(k - j):
            row.append(cb.AND(a[i], b[j]))
        pps.append(Word(tuple(row[:k])))
    return _sum_tree(cb, pps, k)


def xfbq_encode(cb: CircuitBuilder, a: Word) -> Word:
    """XFBQ(x) = (x >> 1) with MSB set: digit i represents ±2^i via bit.

    value(x̂) = 2·int(bits) − (2^k − 1);  Q error = INV(LSB(x)) ∈ {0,1}
    (free: pure rewiring).
    """
    k = len(a)
    bits = a.bits[1:] + (cb.constant(1),)
    return Word(bits[:k])


def mul_xfbq(
    cb: CircuitBuilder,
    a: Word,
    b: Word,
    width: Optional[int] = None,
    qerror_terms: bool = False,
) -> Word:
    """Multiply via XFBQ digits: partial products are XNOR (free).

    Given â = XFBQ(a), b̂ = XFBQ(b) with values A = 2ia−M, B = 2ib−M
    (ia := int(â bits), M := 2^k−1):

        A·B = Σ_j 2^j · (2·PP_j − M)·(2 b̂_j−1 sign)  …

    concretely: digit product p_ij = XNOR(â_i, b̂_j) represents ±2^{i+j}, so
        A·B = 2·Σ_j 2^j int(PP_j) · 2 − … ⇒ implemented as
        A·B = 4·Σ_j 2^j int(PP_j) − 2M·Σ_j 2^j b̂ … (constants fold)

    We use the direct form: A·B = Σ_{i,j} (2 p_ij − 1) 2^{i+j}
        = 2·Σ_j 2^j·int(PP_j) − M²  where PP_j = Σ_i p_ij 2^i.
    Only the adder tree costs ANDs. With ``qerror_terms``, the exact product
    a·b = (A−eA)(B−eB) is recovered with two conditional adds + a 1-bit AND.
    """
    k = width or len(a)
    ah, bh = xfbq_encode(cb, a), xfbq_encode(cb, b)
    pps: List[Word] = []
    for j in range(min(len(bh), k)):
        row = [cb.constant(0)] * j
        for i in range(k - j):
            # XNOR — free (XOR + INV)
            row.append(cb.INV(cb.XOR(ah[i], bh[j])))
        pps.append(Word(tuple(row[:k])))
    s = _sum_tree(cb, pps, k)  # Σ_j 2^j int(PP_j)  (mod 2^k)
    prod = shift_left_const(cb, s, 1)  # ×2
    m = (1 << k) - 1
    prod = add_const(cb, prod, (-(m * m)) % (1 << k))  # − M² (free adds)

    if qerror_terms:
        # eA = INV(a0), eB = INV(b0); a·b = ÂB̂ − eA·B̂ − eB·Â + eA·eB
        ea, eb = cb.INV(a[0]), cb.INV(b[0])
        # B̂ value = 2·int(bh) − M: assemble as word (2·bh − M)
        bval = add_const(cb, shift_left_const(cb, Word(bh.bits), 1), (-m) % (1 << k))
        aval = add_const(cb, shift_left_const(cb, Word(ah.bits), 1), (-m) % (1 << k))
        zero = cb.const_word(0, k)
        prod = sub(cb, prod, mux(cb, ea, bval, zero))
        prod = sub(cb, prod, mux(cb, eb, aval, zero))
        ee = cb.AND(ea, eb)
        prod = add(cb, prod, Word((ee,) + tuple(cb.constant(0) for _ in range(k - 1))))
    return prod


def mul(cb: CircuitBuilder, a: Word, b: Word, style: str = "xfbq",
        width: Optional[int] = None, qerror_terms: bool = False) -> Word:
    if style == "xfbq":
        return mul_xfbq(cb, a, b, width, qerror_terms)
    return mul_conventional(cb, a, b, width)


def mul_const(cb: CircuitBuilder, a: Word, value: int,
              width: Optional[int] = None) -> Word:
    """Multiply by a public constant: shift-and-add, no partial-product ANDs."""
    k = width or len(a)
    value %= 1 << k
    terms: List[Word] = []
    i = 0
    while value:
        if value & 1:
            terms.append(shift_left_const(cb, a, i))
        value >>= 1
        i += 1
    if not terms:
        return cb.const_word(0, k)
    return _sum_tree(cb, terms, k)


# ---------------------------------------------------------------------------
# fixed-point helpers (scale = 2^frac)
# ---------------------------------------------------------------------------


def fx_mul(cb: CircuitBuilder, a: Word, b: Word, frac: int, style="xfbq",
           qerror_terms=False) -> Word:
    """Fixed-point multiply with arithmetic right-shift by `frac`.

    The product is formed in a word widened by frac+1 bits so values up to
    the format's full integer range cannot wrap before the shift; the
    result is truncated back to k bits (the protocol's local-truncation
    rule).
    """
    k = len(a)
    kw = k + frac + 1
    aw = sign_extend(cb, a, kw)
    bw = sign_extend(cb, b, kw)
    p = mul(cb, aw, bw, style=style, width=kw, qerror_terms=qerror_terms)
    ps = shift_right_const(cb, p, frac, arithmetic=True)
    return Word(ps.bits[:k])
