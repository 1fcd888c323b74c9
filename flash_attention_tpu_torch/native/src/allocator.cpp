// Page allocator for the paged KV cache — native runtime component.
//
// Free-list over a fixed pool of physical pages (the device-side arrays in
// ops/paged.py). The serving engine acquires a sequence's full page budget at
// admission and releases it at completion; O(1) acquire/release, no
// fragmentation by construction (pages are interchangeable).

#include <cstdint>
#include <mutex>
#include <vector>

namespace {

struct PageAllocator {
  std::mutex mu;
  std::vector<int32_t> free_list;  // stack of free physical page ids
  int32_t total;

  explicit PageAllocator(int32_t num_pages) : total(num_pages) {
    free_list.reserve(num_pages);
    // Descending so pages are handed out in ascending id order (nicer to
    // debug; no performance meaning).
    for (int32_t i = num_pages - 1; i >= 0; --i) free_list.push_back(i);
  }
};

}  // namespace

extern "C" {

void* fat_alloc_create(int32_t num_pages) {
  if (num_pages <= 0) return nullptr;
  return new PageAllocator(num_pages);
}

void fat_alloc_destroy(void* h) { delete static_cast<PageAllocator*>(h); }

// Acquire `n` pages into out_pages. All-or-nothing: returns n on success,
// -1 if fewer than n pages are free (nothing is taken).
int32_t fat_alloc_acquire(void* h, int32_t n, int32_t* out_pages) {
  auto* a = static_cast<PageAllocator*>(h);
  std::lock_guard<std::mutex> lock(a->mu);
  if (n <= 0 || static_cast<size_t>(n) > a->free_list.size()) return -1;
  for (int32_t i = 0; i < n; ++i) {
    out_pages[i] = a->free_list.back();
    a->free_list.pop_back();
  }
  return n;
}

// Release pages back to the pool. Double-free is the caller's bug; the
// allocator does not police it (O(1) release by design).
void fat_alloc_release(void* h, const int32_t* pages, int32_t n) {
  auto* a = static_cast<PageAllocator*>(h);
  std::lock_guard<std::mutex> lock(a->mu);
  for (int32_t i = 0; i < n; ++i) a->free_list.push_back(pages[i]);
}

int32_t fat_alloc_free_count(void* h) {
  auto* a = static_cast<PageAllocator*>(h);
  std::lock_guard<std::mutex> lock(a->mu);
  return static_cast<int32_t>(a->free_list.size());
}

}  // extern "C"
