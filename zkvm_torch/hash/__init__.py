"""Hash layer: SoA BLAKE3 row hashing (kernel K2), the Merkle heap and host
tree, and the golden BLAKE3 and Rescue."""
