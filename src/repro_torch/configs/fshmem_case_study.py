"""The paper's own case-study workload (Sec. V): parallel matmul and
convolution on 2 nodes with a 16×8-PE DLA per node (a copy of
``repro.configs.fshmem_case_study``).

Matrix sizes 256/512/1024; conv 64×64 fmaps with (256, 3×3), (192, 5×5),
(128, 7×7) kernel sets.
"""

import dataclasses


@dataclasses.dataclass(frozen=True)
class CaseStudyConfig:
    n_nodes: int = 2
    dla_pes: int = 16 * 8          # PEs per DLA
    dla_clock_hz: float = 250e6    # DLA @ 250 MHz
    matmul_sizes: tuple = (256, 512, 1024)
    conv_fmap: int = 64
    conv_sets: tuple = ((256, 3), (192, 5), (128, 7))
    art_chunks: int = 8


config = CaseStudyConfig()
