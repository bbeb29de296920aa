"""cls_numops: server-side numeric ops on object bytes (reference
src/cls/numops/: add/sub/mul on values stored in the object)."""

from __future__ import annotations

import errno
import json

from . import ClsContext, ClsError, register_class


def _value(ctx: ClsContext) -> float:
    raw = ctx.read()
    if not raw:
        return 0.0
    try:
        return float(raw.decode())
    except ValueError:
        raise ClsError(errno.EINVAL, "object does not hold a number")


def _apply(ctx: ClsContext, inp: bytes, op) -> bytes:
    req = json.loads(inp.decode())
    out = op(_value(ctx), float(req["value"]))
    if out == int(out):
        out = int(out)
    ctx.write_full(str(out).encode())
    return str(out).encode()


register_class("numops", {
    "add": lambda ctx, inp: _apply(ctx, inp, lambda a, b: a + b),
    "sub": lambda ctx, inp: _apply(ctx, inp, lambda a, b: a - b),
    "mul": lambda ctx, inp: _apply(ctx, inp, lambda a, b: a * b),
})
