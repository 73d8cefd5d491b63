"""The harness core: cells, traffic, the program's set-up, the window, the trace and the check."""
