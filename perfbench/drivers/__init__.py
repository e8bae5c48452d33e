"""The general generators that traffic files name (``"driver"``).  Each
module offers ``build(cell, seed, spans, device)``, which does the cell's
set-up and returns a run with ``window(seconds, profile)``, ``release()``
and ``check()``."""
