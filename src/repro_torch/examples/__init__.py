"""The MLP examples on the port (counterparts of ``examples/quickstart.py``
and ``examples/adaptive_serving.py``), inside the package: run them with
``python -m repro_torch.examples.quickstart`` (on the CUDA card, or
``--device cpu``)."""
