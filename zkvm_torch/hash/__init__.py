"""Hash layer: SoA BLAKE3 row hashing (kernel K2) and the Merkle heap."""
