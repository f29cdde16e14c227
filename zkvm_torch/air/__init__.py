"""AIR layer: periodic columns and the fused composition (kernel K3)."""
