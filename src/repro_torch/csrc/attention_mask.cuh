// The attention masks of kernel K2 (flash_attention.cu, and its any-dims
// variant attention_any.cu): full, causal, sliding (window) and sumi
// (n_history causal rows, then candidates that see the history and
// themselves), with a query row at absolute key position q_offset + row.
#pragma once

namespace flame {

enum Mode { kFull = 0, kCausal = 1, kSliding = 2, kSumi = 3 };

// Is key `col` visible to the query at absolute position a?
__device__ __forceinline__ bool visible(int mode, int a, int col, int window,
                                        int n_history) {
  switch (mode) {
    case kFull:
      return true;
    case kCausal:
      return col <= a;
    case kSliding:
      return col <= a && a - col < window;
    default:  // kSumi
      return a < n_history ? col <= a : (col < n_history || col == a);
  }
}

// How the rows at absolute positions [A0, A1] see keys [c0, c1]: 0 none of
// them, 1 all, 2 some (the per-element mask runs).
__device__ __forceinline__ int tile_state(int mode, int A0, int A1, int c0,
                                          int c1, int window, int n_history) {
  switch (mode) {
    case kFull:
      return 1;
    case kCausal:
      return c0 > A1 ? 0 : (c1 <= A0 ? 1 : 2);
    case kSliding:
      if (c0 > A1 || c1 < A0 - window + 1) return 0;
      return c1 <= A0 && c0 >= A1 - window + 1 ? 1 : 2;
    default:  // kSumi
      if (c1 < n_history) {  // history keys
        if (c0 > A1 && A1 < n_history) return 0;
        return A0 >= n_history || c1 <= A0 ? 1 : 2;
      }
      if (c0 >= n_history) {  // own keys: only the diagonal
        return c0 > A1 || c1 < A0 ? 0 : 2;
      }
      return 2;
  }
}

}  // namespace flame
