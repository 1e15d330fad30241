"""The photon-packet lifecycle engine (launch / traverse / absorb / scatter
/ peel-off) as batched event kernels."""
