"""Runtime analysis helpers: the lock-order checker."""
