"""Examples that run on the port: the linear regression over encrypted
inputs (:mod:`.linear_regression`) and its 2^20-row form
(:mod:`.prove_lr_large`)."""
