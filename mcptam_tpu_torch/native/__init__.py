"""Native runtime libraries of the port (ctypes, built at first use)."""
