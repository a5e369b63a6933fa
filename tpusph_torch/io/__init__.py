"""Host I/O of the torch port."""
