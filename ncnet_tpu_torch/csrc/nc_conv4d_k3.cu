// The k = 3 layers of the NC forward kernel and its transposed launch
// (nc_conv4d.cuh): one translation unit a kernel size, built in parallel.
#define NC_K 3
#include "nc_conv4d.cuh"
