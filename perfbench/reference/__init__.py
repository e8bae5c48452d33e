"""The plain reference the program is judged against: plain PyTorch and
NumPy, importing nothing of the program (``repro_torch``), of the JAX
package or of ``benchmarks/``.  Frozen copies of what it needs live here."""
