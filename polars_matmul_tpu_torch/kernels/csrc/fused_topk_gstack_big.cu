// Kernel A's gstack selection above kAppendMaxK (fused_topk.cu's SEL
// kGstackBig): its instantiations, compiled apart from the rest of kernel
// A and from the gstack unit below kAppendMaxK so that the build's
// compiler processes, one a source, run them at the same time.
// fused_topk.cu holds the code and says what the selection does; this unit
// defines only pmm_fused_topk_gstack_big_launch, which kernel A's launch
// calls for selection="gstack" at k > 128.
#define PMM_GSTACK_BIG_UNIT
#include "fused_topk.cu"
