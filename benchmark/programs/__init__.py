"""The programs a cell drives, one module each, named by a configuration's
``"program"`` (``uniform``: the port's uniform ``Simulation``)."""
