"""Command-line tools of the port (the kernel microbench)."""
