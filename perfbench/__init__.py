"""The benchmark of the PyTorch and CUDA port (`bbx_torch`).

`perfbench/run.py` runs one cell once; `perfbench/harness.py` says how a
cell's files are found.  Nothing here imports JAX or the JAX package.
"""
