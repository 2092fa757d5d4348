"""The benchmark's general code: cells found by name (``spec``), one run
(``cell``), the trace's arithmetic (``trace``) and the comparison with the
plain reference (``compare``)."""
