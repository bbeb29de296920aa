"""The plain reference of the benchmark: GF(2^8) fields, Cauchy
Reed-Solomon, crc32c and CLAY, in NumPy and plain PyTorch.  Frozen
copies of the arithmetic the codecs state; nothing here imports the
program under test."""
