"""GF(2^m) arithmetic and GF(2) polynomial helpers (numpy / Python-int based).

Used to derive the DVB-S2 BCH generator polynomials and to build the LUTs the
batched BCH decoder gathers from. Behavior parity with reference
``lib/gf.cc``/``lib/gf.h`` (construction by LFSR, multiply via exp/log).
Copy of ``dvbs2rx_tpu/spec/galois.py`` without the unused inverse, divide
and power.
"""

import functools

import numpy as np

# Primitive polynomials (reference ``lib/bch_decoder_bb_impl.cc:57-66``):
PRIM_POLY_NORMAL = 0b10000000000101101  # GF(2^16): x^16 + x^5 + x^3 + x^2 + 1
PRIM_POLY_SHORT = 0b100000000101011     # GF(2^14): x^14 + x^5 + x^3 + x + 1
PRIM_POLY_MEDIUM = 0b1000000000101101   # GF(2^15): x^15 + x^5 + x^3 + x^2 + 1


class GF2m:
    """Galois field GF(2^m) with exp/log tables built from a primitive poly."""

    def __init__(self, prim_poly: int):
        m = prim_poly.bit_length() - 1
        self.m = m
        self.order = 1 << m
        self.prim_poly = prim_poly
        exp = np.zeros(2 * (self.order - 1), dtype=np.int64)
        log = np.zeros(self.order, dtype=np.int64)
        x = 1
        for i in range(self.order - 1):
            exp[i] = x
            log[x] = i
            x <<= 1
            if x & self.order:
                x ^= prim_poly
        # duplicate for mod-free indexing of exp[(i + j) % (order-1)]
        exp[self.order - 1:] = exp[: self.order - 1]
        self.exp = exp
        self.log = log

    def multiply(self, a, b):
        a = np.asarray(a, dtype=np.int64)
        b = np.asarray(b, dtype=np.int64)
        res = self.exp[self.log[a] + self.log[b]]
        return np.where((a == 0) | (b == 0), 0, res)

    def alpha_pow(self, e):
        return self.exp[np.asarray(e) % (self.order - 1)]

    def conjugates(self, beta: int):
        """The conjugacy class {beta, beta^2, beta^4, ...}."""
        out = []
        b = beta
        while b not in out:
            out.append(b)
            b = int(self.multiply(b, b))
        return out

    def min_poly(self, beta: int) -> int:
        """Minimal polynomial of beta as a GF(2) polynomial (Python int, bit i
        = coefficient of x^i)."""
        # prod over conjugates c of (x + c), computed with GF(2^m) coefficients
        poly = [1]  # coefficients in GF(2^m), poly[i] = coeff of x^i
        for c in self.conjugates(beta):
            # poly = poly * (x + c)
            new = [0] * (len(poly) + 1)
            for i, p in enumerate(poly):
                new[i + 1] ^= p  # p * x
                new[i] ^= int(self.multiply(p, c))
            poly = new
        assert all(p in (0, 1) for p in poly), "minimal poly must be binary"
        out = 0
        for i, p in enumerate(poly):
            out |= p << i
        return out


@functools.lru_cache(maxsize=8)
def gf(prim_poly: int) -> GF2m:
    return GF2m(prim_poly)


# ---- GF(2) polynomial helpers on Python ints (bit i = coeff of x^i) ----

def gf2_poly_mul(a: int, b: int) -> int:
    r = 0
    while b:
        if b & 1:
            r ^= a
        a <<= 1
        b >>= 1
    return r


def gf2_poly_rem(a: int, b: int) -> int:
    db = b.bit_length() - 1
    while a.bit_length() - 1 >= db and a:
        a ^= b << (a.bit_length() - 1 - db)
    return a


def gf2_poly_lcm(a: int, b: int) -> int:
    return gf2_poly_div(gf2_poly_mul(a, b), gf2_poly_gcd(a, b))[0]


def gf2_poly_gcd(a: int, b: int) -> int:
    while b:
        a, b = b, gf2_poly_rem(a, b)
    return a


def gf2_poly_div(a: int, b: int):
    """Returns (quotient, remainder)."""
    db = b.bit_length() - 1
    q = 0
    while a.bit_length() - 1 >= db and a:
        shift = a.bit_length() - 1 - db
        q |= 1 << shift
        a ^= b << shift
    return q, a
