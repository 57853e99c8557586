"""Data of the port: the synthetic video clips of the JAX package's
`data/synthetic.py`, as an own copy, behind a `torch.utils.data`
loader."""
