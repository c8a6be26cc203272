// Flash attention for Hopper (sm_90a) on f16 operands: the kernels of
// flash_attention.cu, which are templates on the 16-bit element type,
// instantiated for __half. f16 is a wgmma operand type beside bf16 with the
// same m64nNk16 shapes and f32 accumulation, and TMA moves its 2-byte
// elements with the same boxes and swizzles, so the kernels, their tiles and
// their shared-memory plans are bf16's; the products' opcode, the tensor
// maps' data type and the rounding of P, dS and the outputs into operands
// are f16's. A library of its own, so the two build at once.
#define RT_OPERAND __half
#include "flash_attention.cu"
