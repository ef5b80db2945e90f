from bipymc_tpu.ops.distance import pairwise_sqdist
from bipymc_tpu.ops.linalg import chol_rank1_update
