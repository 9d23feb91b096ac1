"""The cases a configuration can name (``"case"``): one module each,
``<case>.py``, with ``make(conf, seed, device, dtype)`` ->
:class:`pombench.inputs.Inputs`."""
