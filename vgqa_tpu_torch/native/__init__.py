"""Native (C++) runtime components, loaded via ctypes."""
