"""The `cspc-torch` command line."""
