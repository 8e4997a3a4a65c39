// The k = 7 layers of the NC backward's dW/db kernel and its reduction
// (nc_conv4d_vjp.cuh): one translation unit a kernel size, built in
// parallel.
#define NC_K 7
#include "nc_conv4d_vjp.cuh"
