"""The paper's own workload: Europarl-scale RandomizedCCA.

Port of ``repro/configs/europarl_cca.py``, same numbers: n = 1,235,976
paired sentences; feature hashing into 2^19 slots per view; k = 60,
p = 2000, q = 1, ν = 0.01 (paper §4); row chunks of 8192.
"""

import dataclasses

from ..core.rcca import RCCAConfig


@dataclasses.dataclass(frozen=True)
class CCAWorkload:
    name: str
    n: int
    da: int
    db: int
    rcca: RCCAConfig
    chunk: int  # streaming row-chunk size per data pass


def config() -> CCAWorkload:
    return CCAWorkload(
        name="europarl-cca",
        n=1_235_976,
        da=2**19,
        db=2**19,
        rcca=RCCAConfig(k=60, p=2000, q=1, nu=0.01, center=False),
        chunk=8192,
    )


def smoke_config() -> CCAWorkload:
    return CCAWorkload(
        name="europarl-cca-smoke",
        n=4096,
        da=256,
        db=192,
        rcca=RCCAConfig(k=8, p=24, q=1, nu=0.01, center=False),
        chunk=512,
    )
