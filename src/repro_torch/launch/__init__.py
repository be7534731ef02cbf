"""Launch layer of the port: device meshes (``mesh``), the token-serving
and training launchers (``serve``, ``train``), and the dry-run (``dryrun``,
with ``specs`` and the roofline terms and hardware dicts, ``roofline``).
Nothing here is imported by the package's import: ``dryrun`` and the
launchers are entry points."""
