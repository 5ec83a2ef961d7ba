"""The port's examples, each run as ``python -m repro_torch.examples.<name>``
and each the counterpart of the reference's ``examples/<name>.py``: on the
card unless ``--device cpu`` is given."""
