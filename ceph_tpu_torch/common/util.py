"""Small shared helpers with no dependencies above common/."""


def next_pow2(n: int) -> int:
    """Smallest power of two >= n (n >= 1).  The log-depth crc combine
    (ops/crc32c_linear.combine_crcs_pow2) pads its block count to this
    with a zero prefix, which leaves the combined value unchanged."""
    return 1 << (n - 1).bit_length()
