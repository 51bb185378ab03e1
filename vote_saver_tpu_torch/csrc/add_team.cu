// The loop-mode instance of K3 in G2, the complete Jacobian add as a team
// of 16 threads a lane (add_team.cuh: the kernel, what it replaces, what
// bounds it and its design), and its extern "C" launcher.  Its v1 and fold
// instances are in curve_v1.cu and curve_fold.cu.

#include "add_team.cuh"

extern "C" {

// coordinates (n, 2, 12) each, int32 limbs read as uint4, 16-byte aligned;
// the outputs must not alias the inputs.
int vs_g2_add_team(const void* px, const void* py, const void* pz, const void* qx,
                   const void* qy, const void* qz, void* ox, void* oy, void* oz, long long n,
                   void* stream) {
  return launch_g2_add_team<MulLoop>(px, py, pz, qx, qy, qz, ox, oy, oz, n, stream);
}

}  // extern "C"
