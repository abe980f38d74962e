"""Numerical ops: ALS, the SPD solve kernel, top-k scoring."""
