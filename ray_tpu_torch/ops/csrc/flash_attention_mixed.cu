// Flash attention for operands of mixed dtypes (bf16, f16 and f32 beside
// each other), on the f32 kernels of flash_attention_f32.cu: the caller
// casts every operand up to f32, and these instances round P and dS to the
// dtypes the Pallas kernels cast them to before each product (RT_ROUNDED:
// the rounding types are the entry points' round_p and round_ds). A library
// of its own, so it builds beside the others at once.
#define RT_ROUNDED 1
#include "flash_attention_f32.cu"
