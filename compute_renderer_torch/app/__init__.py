"""Host surfaces of the port: the headless frame loop (``headless``)
behind the CLI. The JAX package's HTTP viewer and display window are not
ported yet."""
