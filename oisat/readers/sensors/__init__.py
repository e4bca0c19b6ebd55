"""Per-sensor fleet readers (glob a month of files, decode, regrid).

Equivalents of the reference fleet readers (reference
oisatgmi/reader.py:1307-1464).  Each fleet reader fans the per-file decode
out over a host pool and regrids granules through
:mod:`oisat.regridder`.
"""

from oisat.readers.sensors.omi import omi_reader
from oisat.readers.sensors.tempo import tempo_reader
from oisat.readers.sensors.tropomi import tropomi_reader
from oisat.readers.sensors.omps import omps_reader
from oisat.readers.sensors.mopitt import mopitt_reader
from oisat.readers.sensors.gosat import gosat_reader
from oisat.readers.sensors.ssmis import ssmis_reader

__all__ = [
    "omi_reader", "tempo_reader", "tropomi_reader", "omps_reader",
    "mopitt_reader", "gosat_reader", "ssmis_reader",
]
