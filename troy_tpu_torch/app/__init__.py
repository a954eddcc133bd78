"""Applications on the HE layer: private matmul and conv2d (app/linear.py)."""
