// Kernel A's stack selection (fused_topk.cu's SEL kStack, the port of the
// TPU kernel's _select_stack): its instantiations, compiled apart from the
// rest of kernel A so that the build's compiler processes, one a source,
// run them at the same time.  fused_topk.cu holds the code and says what
// the selection does; this unit defines pmm_fused_topk_stack_launch, which
// kernel A's launch calls for alt kStack, and pmm_fused_topk_stack, its
// plan.
#define PMM_STACK_UNIT
#include "fused_topk.cu"
