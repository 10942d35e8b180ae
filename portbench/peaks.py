"""Published peaks of one NVIDIA H100 SXM (the data sheet, at its 700 W
limit; the run prints the card's own limit beside its numbers)."""

H100_HBM_BYTES_PER_S = 3.35e12
