"""NTT layer: the transposed four-step NTT (stage network: kernel K1), the
coset LDE and the golden NTT."""
