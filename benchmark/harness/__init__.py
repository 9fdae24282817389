"""The benchmark's harness: the manifest, the files it finds by name, the
spans, the device trace and the result line.  It imports nothing of the
program; the drivers under ``drivers/`` do."""
