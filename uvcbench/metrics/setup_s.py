"""Set-up seconds: from the interpreter's start to the window's (imports,
the kernel libraries, weights and inputs, the cell's first units)."""


def read(record):
    return record["setup_s"]
