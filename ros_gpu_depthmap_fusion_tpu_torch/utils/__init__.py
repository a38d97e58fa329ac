"""Host-side helpers: the ctypes binding of the native host library."""
