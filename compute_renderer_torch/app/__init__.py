"""Host surfaces of the port: the headless frame loop (``headless``)
behind the CLI, the display window (``window``, tkinter) and the HTTP
viewer (``webview``). All three render through ``Renderer`` on the card
unless the caller asks for the CPU; the viewers share the pipelined
present (``window.FramePipe``)."""
