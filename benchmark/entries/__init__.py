"""The timed entries, one file a pair of entry and source:
`<entry>_<source>.py`, whose `ENTRY` class harness/entry.py loads by
the names in a cell's traffic file."""
