"""NeRF positional encoding, channel-leading.

Counterpart of ``stnerf_tpu/ops/encoding.py``: log-spaced frequencies
2^0 .. 2^(L-1), channel order ``[x | sin(2^0 x) | cos(2^0 x) | sin(2^1 x) |
...]`` with the raw input optionally prepended.
"""

from __future__ import annotations

import torch


def encoding_dim(input_dim: int, num_freqs: int, include_input: bool = True) -> int:
    return input_dim * ((1 if include_input else 0) + 2 * num_freqs)


def positional_encoding_planar(x: torch.Tensor, num_freqs: int,
                               include_input: bool = True,
                               recursive: bool = False) -> torch.Tensor:
    """(C, ...) -> (C * (include + 2L), ...).

    ``recursive=True`` derives sin/cos(2^k x) by double-angle recursion
    from one sin/cos pair, as the fused field kernel does; the default
    exact form evaluates every octave's sin/cos directly.
    """
    if num_freqs == 0:
        return x if include_input else x[:0]
    pieces = [x] if include_input else []
    if recursive:
        s, c = torch.sin(x), torch.cos(x)
        pieces += [s, c]
        for _ in range(num_freqs - 1):
            s, c = 2.0 * s * c, 1.0 - 2.0 * s * s
            pieces += [s, c]
        return torch.cat(pieces, dim=0)
    for i in range(num_freqs):
        xf = x * (2.0 ** i)
        pieces.append(torch.sin(xf))
        pieces.append(torch.cos(xf))
    return torch.cat(pieces, dim=0)


def lerp_encoded_time_planar(xyz: torch.Tensor, t: torch.Tensor,
                             num_freqs: int, include_input: bool = True,
                             recursive: bool = False) -> torch.Tensor:
    """Encode (xyz, t) blending the encodings of floor(t) and floor(t)+1 —
    exact at integer t (ref: modeling/motion_net.py:49-62).

    xyz (C, ...), t (...) -> ((C+1) * (include + 2L), ...).
    """
    lower = torch.floor(t)
    w = t - lower
    e_lo = positional_encoding_planar(torch.cat([xyz, lower[None]], 0),
                                      num_freqs, include_input, recursive)
    e_hi = positional_encoding_planar(torch.cat([xyz, (lower + 1.0)[None]], 0),
                                      num_freqs, include_input, recursive)
    return (1.0 - w) * e_lo + w * e_hi
