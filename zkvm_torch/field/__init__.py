"""f128 field layer: limb conversion and transposed-layout limb arithmetic."""
