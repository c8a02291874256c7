"""Application drivers, one per reference driver: ``run(cfg, device=None)``
and ``main(argv)`` with the JAX drivers' YAML keys, printed lines, CSV
headers and VTU collections."""
