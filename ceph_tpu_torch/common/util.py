"""Small shared helpers with no dependencies above common/."""

import numpy as np


def next_pow2(n: int) -> int:
    """Smallest power of two >= n (n >= 1).  The log-depth crc combine
    (ops/crc32c_linear.combine_crcs_pow2) pads its block count to this
    with a zero prefix, which leaves the combined value unchanged."""
    return 1 << (n - 1).bit_length()


def concat_columns(arrs):
    """[(R, W_i) arrays] -> (concatenated (R, sum W_i), [W_i]).

    The batching idiom of the repair/decode paths: independent
    objects' byte axes ride one launch and demux by column
    (split_columns) — one shared helper so every site slices the
    same way."""
    widths = [a.shape[1] for a in arrs]
    big = arrs[0] if len(arrs) == 1 else np.concatenate(arrs, axis=1)
    return big, widths


def split_columns(out, widths):
    """Inverse of concat_columns on the result array: per-object
    column slices in submission order (trailing pad columns, if the
    launch bucketed, are never touched)."""
    res = []
    col = 0
    for w in widths:
        res.append(out[:, col:col + w])
        col += w
    return res
