"""NTT layer: the transposed four-step NTT (stage network: kernel K1)."""
