"""Plain references, one module per program: the same semantics as the
port's vertex programs, computed with nothing but PyTorch and NumPy from the
inputs the harness draws.  They import nothing of ``repro_torch`` (a test
holds them to that) and take nothing the port made."""
