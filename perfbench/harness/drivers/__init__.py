"""One module a driver kind, found by the name a traffic mix gives under
``"driver"`` (``harness.spec.driver``). Each has

* ``measure(cell, args, program, t_start)``: set the port up, run the
  window, check it; returns a ``harness.report.Result``;
* ``calibrate(cell, seed, seconds, program, control, fault)``: the
  readings a cell's limits are set from, as one dict.
"""
