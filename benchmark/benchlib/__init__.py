"""The benchmark's own code: reading the cell's files, making its inputs
and weights, timing the window, reducing the trace and deciding
``correct`` against the plain reference (``monorun_ref``)."""
