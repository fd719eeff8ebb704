// What every kernel library of miso_tpu_torch exports besides its launchers.
// Each csrc/<name>.cu builds into its own shared library (ops/_build.py), so
// each defines these once, through this header.

#pragma once

#include <cuda_runtime.h>

extern "C" {

const char* mtt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
