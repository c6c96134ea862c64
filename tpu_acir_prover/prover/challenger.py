"""Fiat-Shamir challenger: a duplex Poseidon sponge on the host.

Both prover and verifier drive an identical transcript, so challenges are
sound under Fiat-Shamir.  This is this framework's analog of plonky2's
Challenger (the reference relies on the external fork's Keccak/Poseidon
challenger, SURVEY.md §2.3); we use our Poseidon instantiation throughout.
Host-side on purpose: a transcript is O(hundreds) of permutations, far off
the hot path.
"""

from __future__ import annotations

import numpy as np

from ..field import gl as _gl
from ..field.poseidon import permute_ints as _permute_ints, WIDTH, RATE


class Challenger:
    def __init__(self):
        self.state = [0] * WIDTH
        self.input_buf = []
        self.output_buf = []

    def observe(self, x: int):
        assert 0 <= x < _gl.P
        self.input_buf.append(x)
        if len(self.input_buf) == RATE:
            self._duplex()

    def observe_many(self, xs):
        for x in xs:
            self.observe(int(x))

    def observe_ext(self, x):
        self.observe(x[0])
        self.observe(x[1])

    def observe_cap(self, cap_u64):
        for digest in np.asarray(cap_u64, dtype=np.uint64):
            for el in digest:
                self.observe(int(el))

    def _duplex(self):
        for i, v in enumerate(self.input_buf):
            self.state[i] = v
        self.state = _permute_ints(self.state)
        self.output_buf = list(self.state[:RATE])
        self.input_buf = []

    def get_challenge(self) -> int:
        if self.input_buf or not self.output_buf:
            self._duplex()
        return self.output_buf.pop()

    def get_challenges(self, n) -> list:
        return [self.get_challenge() for _ in range(n)]

    def get_ext_challenge(self):
        return (self.get_challenge(), self.get_challenge())

    def get_indices(self, num: int, domain_size: int):
        """Query indices in [0, domain_size); domain_size a power of two."""
        mask = domain_size - 1
        assert domain_size & mask == 0
        return [self.get_challenge() & mask for _ in range(num)]
