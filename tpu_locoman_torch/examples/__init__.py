"""Command-line examples of the port, run as modules:
``python -m tpu_locoman_torch.examples.run_mpc`` and ``... .run_ocp``."""
