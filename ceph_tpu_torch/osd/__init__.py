"""OSD: the erasure-coded write, read and recovery pipeline (reference
src/osd/)."""
