#pragma once
#include "cuda_bf16.h"
