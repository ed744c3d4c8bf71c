"""Entry points of the port: ``serve`` (the streaming server) and
``export_pipeline`` (the deployment artifact's CLI). Nothing is loaded
here."""
