"""OSD: the erasure-coded write/read pipeline (reference src/osd/)."""
