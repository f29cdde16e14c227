"""f128 field layer: the golden field, limb conversion and transposed-layout
limb arithmetic."""
