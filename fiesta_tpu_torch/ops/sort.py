"""Key-value sort of the endpoint splat (port of
``fiesta_tpu/ops/pallas/sort.py``).

``sort_pairs`` sorts (i32 key, f32 value) pairs ascending by key with the
bitonic network of the TPU kernel: the pairs are padded to
``max(256, next power of two)`` with key ``0x7fffffff`` and value 0, every
stage (s, j) pairs element i with i ^ 2^j and swaps a pair only when its
keys are strictly out of order for the pair's direction (ascending where
bit s of i is 0), and the pad is sliced off.  The output, values included,
is therefore a function of the input alone: the CUDA kernel
(``kernels/sort.cu``) equals the plain network here bit for bit.  Keys must
stay below the pad key.

A CUDA tensor takes the kernel, a CPU tensor the plain network.
"""

from __future__ import annotations

import torch

from .. import kernels


def _sort_pairs_plain(keys: torch.Tensor, vals: torch.Tensor):
    """Plain version: the same bitonic network, one stage at a time, with
    the compare-exchange of ``sort.py:95-99``."""
    n = keys.shape[0]
    n_pad = kernels.sort_padded_size(n)
    dev = keys.device
    k = torch.full((n_pad,), kernels.SORT_SENTINEL, dtype=torch.int32,
                   device=dev)
    v = torch.zeros(n_pad, dtype=torch.float32, device=dev)
    k[:n] = keys
    v[:n] = vals
    i = torch.arange(n_pad, dtype=torch.int64, device=dev)
    log_n = n_pad.bit_length() - 1
    for s in range(1, log_n + 1):
        for j in range(s - 1, -1, -1):
            partner = i ^ (1 << j)
            pk, pv = k[partner], v[partner]
            want_min = ((i >> j) & 1) == ((i >> s) & 1)
            take = (want_min & (pk < k)) | (~want_min & (pk > k))
            k = torch.where(take, pk, k)
            v = torch.where(take, pv, v)
    return k[:n], v[:n]


def sort_pairs(keys: torch.Tensor, vals: torch.Tensor):
    """Sort (keys i32 [N], vals f32 [N]) ascending by key; returns
    (keys [N], vals [N]).  CUDA tensor: the ``sort`` kernel; CPU tensor:
    the plain network."""
    if keys.is_cuda:
        return kernels.sort_pairs(keys, vals)
    return _sort_pairs_plain(keys, vals)
