"""Host-side ingestion: CTM and satellite L2/L3 readers.

Mirrors the reference's ``readers`` facade (reference oisatgmi/reader.py:1466-1630):
``add_ctm_data``/``read_ctm_data`` and ``add_satellite_data``/
``read_satellite_data`` dispatching on product name.  File decode stays on
host; every granule is regridded onto the CTM grid through
:mod:`oisat.regridder` as part of reading (the reference does the same
inside each per-file reader), so downstream stages see only static-shape
gridded fields.
"""

from oisat.readers.facade import readers

__all__ = ["readers"]
