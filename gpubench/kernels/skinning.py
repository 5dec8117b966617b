"""Linear-blend skinning (romp_tpu_torch/csrc/lbs.cu `skinning_tf32_kernel`):
for each person b and vertex v, the blended 3x4 transform T = A[b] W[v]^T
(rows 0-11 of A's 16, over 24 joints) applied to the posed vertex.

Bytes: each input read once (A16 (N, 16, J), W (V, J), v_posed (N, 3, V))
and the output (N, 3, V) written once, all float32. Operations: the
products the algorithm needs, once (12 x J + 12 multiply-adds a person and
vertex), at the TF32 tensor-core peak, however the kernel splits them."""
from gpubench.peaks import TF32_FLOP_PER_S

NAMES = ("skinning_tf32_kernel",)


def launch_work(persons: int, verts: int, joints: int):
    """(bytes, [(flops, peak)]) of one launch over `persons`."""
    nbytes = 4 * (persons * 16 * joints + verts * joints
                  + 2 * persons * 3 * verts)
    flops = 2.0 * persons * verts * (12 * joints + 12)
    return nbytes, [(flops, TF32_FLOP_PER_S)]


def work(config, batch: int):
    """Every launch of one batch of `batch` images: one a SMPL model, over
    all `max_person` slots of every image."""
    smpl = config["smpl"]
    return [launch_work(batch * config["max_person"], smpl["verts"],
                        smpl["joints"]) for _ in smpl["models"]]
