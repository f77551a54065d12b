// The MTTKRP entries of rows 1-4 in fp16 (mttkrp_entries.cuh): the shared
// body (mttkrp_cluster.cuh) reading fp16 and summing in fp32, float output.
#include "mttkrp_entries.cuh"

MTTKRP_ENTRIES(__half, f16)
