"""The entries: how a cell drives the program, one module each, found by
the ``entry`` of its workload file."""
