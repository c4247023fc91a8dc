"""One module a kind of cell (``serve``, ``train``), named by the cell's file:
``run(run) -> record`` sets up and measures, ``counts(record)`` gives the
requests or steps attempted and failed, ``check(record, run, control)`` frees
the program's state and returns the numbers its comparison reads."""
