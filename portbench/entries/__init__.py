"""What a cell calls, found by name: ``entries/<name>.py``, named by a
traffic mix's ``entry`` key (``run.entry_module``)."""
