"""Host utilities: audio I/O, metrics writer, debugging aids."""
