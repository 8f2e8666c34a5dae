// The cluster part of cooperative groups, for the stand-in of
// cuda_runtime.h beside this file.
#pragma once
#include "cuda_runtime.h"
