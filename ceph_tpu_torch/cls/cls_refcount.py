"""cls_refcount: tag-based refcounting (reference src/cls/refcount/):
get/put named refs on an object; drop to zero -> caller may delete."""

from __future__ import annotations

import json

from . import ClsContext, register_class

ATTR = "cls_refcount.refs"


def _load(ctx: ClsContext) -> list:
    raw = ctx.getxattr(ATTR)
    return json.loads(raw.decode()) if raw else []


def get(ctx: ClsContext, inp: bytes) -> bytes:
    tag = json.loads(inp.decode())["tag"]
    refs = _load(ctx)
    if tag not in refs:
        refs.append(tag)
    ctx.setxattr(ATTR, json.dumps(refs).encode())
    return json.dumps({"refs": refs}).encode()


def put(ctx: ClsContext, inp: bytes) -> bytes:
    tag = json.loads(inp.decode())["tag"]
    refs = _load(ctx)
    if tag in refs:
        refs.remove(tag)
    ctx.setxattr(ATTR, json.dumps(refs).encode())
    return json.dumps({"refs": refs}).encode()


def read(ctx: ClsContext, inp: bytes) -> bytes:
    return json.dumps({"refs": _load(ctx)}).encode()


register_class("refcount", {"get": get, "put": put, "read": read})
