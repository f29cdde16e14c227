"""AIR layer: layout, golden constraints, periodic columns, the fused
composition (kernel K3) and the merged transition (kernel K4)."""
