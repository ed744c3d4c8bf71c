"""Host utilities of the port: ``meters`` and ``monitoring``. Import
submodules directly; nothing is loaded here."""
