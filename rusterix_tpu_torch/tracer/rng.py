"""Threefry-2x32 keys with JAX's bits, for the path tracer.

The JAX package's tracer draws its jitter, its specular and diffuse
choices and its Russian roulette from `jax.random` (`PRNGKey`, `split`,
`fold_in`, `uniform`) under the default threefry-2x32 implementation with
the partitionable counter layout (`jax_threefry_partitionable`, on by
default). A `Key` here gives the same bits: a key is a pair of u32 words
held on the host as Python ints, `split` and `fold_in` hash on the host
(a few words), and `uniform_many` hashes one counter per element on a
torch device, for several draws in one pass. The words are int64 tensors
masked to 32 bits: torch's uint32 lacks arithmetic on some devices.

Layout (jax/_src/prng.py): `PRNGKey(seed)` is (seed >> 32, seed & 0xffffffff)
(the high word 0 for a 32-bit seed); `split(key, n)[i]` and
`fold_in(key, i)` are both threefry2x32(key, (0, i)); `uniform(key, shape)`
hashes the flat index i of each element as the counter (i >> 32, i &
0xffffffff) and keeps the XOR of the two output words, whose top 23 bits
become the mantissa of a float in [1, 2), minus 1.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

_MASK = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & _MASK


def threefry2x32(k0, k1, x0, x1):
    """The Threefry-2x32 block cipher, 20 rounds, as jax.random's
    `threefry2x32_p`. Keys and counters are Python ints or int64 tensors
    holding u32 values (broadcast together) -> (y0, y1) alike."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & _MASK
    x1 = (x1 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _MASK
    return x0, x1


@dataclass(frozen=True)
class Key:
    """A threefry key: two u32 words on the host."""

    k0: int
    k1: int

    def split(self, n: int) -> list:
        """jax.random.split(key, n), key by key."""
        return [self.fold_in(i) for i in range(int(n))]

    def fold_in(self, data: int) -> "Key":
        """jax.random.fold_in(key, data) for a data word below 2**32."""
        return Key(*threefry2x32(self.k0, self.k1, 0, int(data) & _MASK))


def PRNGKey(seed: int) -> Key:
    """jax.random.PRNGKey(seed) for an integer seed: JAX takes a seed
    below 2**32 as a 32-bit word (the high word 0, a negative seed by its
    two's complement)."""
    seed = int(seed)
    return Key((seed >> 32) & _MASK if seed >= 1 << 32 else 0, seed & _MASK)


def uniform_bits(draws, device) -> list:
    """The 32-bit words of several draws [(key, n), ...] in one pass of the
    cipher over their concatenated counters -> one int64 tensor (n,) each:
    the words jax.random.bits(key, (n,)) gives, each draw's of its key
    alone."""
    counts = [int(n) for _, n in draws]
    total = sum(counts)
    if total >= 1 << 32:
        raise ValueError("a draw of 2**32 words or more")
    if len(draws) == 1:
        (key, n), = draws
        k0, k1 = key.k0, key.k1
        ctr = torch.arange(n, dtype=torch.int64, device=device)
    else:
        # each draw's key words and first counter, spread over its elements
        # on the device (a few words cross to it, not one per element)
        table = torch.tensor([[k.k0, k.k1, start] for (k, _), start in
                              zip(draws, np.cumsum([0] + counts[:-1]))],
                             dtype=torch.int64).to(device)
        rep = torch.tensor(counts, dtype=torch.int64).to(device)
        per = torch.repeat_interleave(table, rep, dim=0, output_size=total)
        k0, k1 = per[:, 0], per[:, 1]
        ctr = torch.arange(total, dtype=torch.int64, device=device) - per[:, 2]
    y0, y1 = threefry2x32(k0, k1, torch.zeros_like(ctr), ctr)
    out = y0 ^ y1
    return list(torch.split(out, counts)) if len(draws) > 1 else [out]


def bits_to_unit(bits: torch.Tensor) -> torch.Tensor:
    """u32 words (int64) -> f32 in [0, 1) as jax.random.uniform makes them:
    the top 23 bits as the mantissa of [1, 2), minus 1."""
    mant = ((bits >> 9) | 0x3F800000).to(torch.int32)
    return mant.view(torch.float32) - 1.0


def uniform_many(draws, device) -> list:
    """jax.random.uniform(key, shape) for several draws [(key, shape), ...]
    in one pass of the cipher -> one f32 tensor of each shape."""
    shapes = [tuple(int(s) for s in shape) for _, shape in draws]
    sizes = [int(np.prod(s)) for s in shapes]
    bits = uniform_bits([(k, n) for (k, _), n in zip(draws, sizes)], device)
    return [bits_to_unit(b).reshape(s) for b, s in zip(bits, shapes)]
