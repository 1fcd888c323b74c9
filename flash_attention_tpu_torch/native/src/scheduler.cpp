// Continuous-batching scheduler — native runtime component.
//
// The reference's host-side runtime is C++ (harness + dispatcher,
// flash_attention.cu:606-974); our serving runtime keeps the same split:
// device compute in Pallas/XLA, host-side request lifecycle in C++. This
// module owns the request queue, the fixed-slot batch allocator, and the
// per-slot decode state machine; the Python engine (serving/engine.py) asks
// it what to prefill/decode each step and reports tokens back.
//
// Thread-safety: a single mutex guards all state (the engine loop is the only
// hot caller; contention is nil). Exposed as a C ABI for ctypes.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <deque>
#include <mutex>
#include <unordered_map>
#include <vector>

namespace {

enum class SlotState : int32_t { kFree = 0, kPrefill = 1, kDecode = 2 };

struct Request {
  int64_t id;
  int32_t prompt_len;
  int32_t max_new_tokens;
  int64_t arrival;  // monotonic submit counter (FIFO order)
};

struct Slot {
  SlotState state = SlotState::kFree;
  int64_t req_id = -1;
  int32_t prompt_len = 0;
  int32_t max_new_tokens = 0;
  int32_t generated = 0;
};

struct Scheduler {
  std::mutex mu;
  int32_t max_slots;
  int32_t max_seq;
  int64_t submit_counter = 0;
  int64_t completed = 0;
  int64_t rejected = 0;
  std::deque<Request> queue;
  std::vector<Slot> slots;

  explicit Scheduler(int32_t n_slots, int32_t mseq)
      : max_slots(n_slots), max_seq(mseq), slots(n_slots) {}
};

}  // namespace

extern "C" {

void* fat_sched_create(int32_t max_slots, int32_t max_seq) {
  if (max_slots <= 0 || max_seq <= 0) return nullptr;
  return new Scheduler(max_slots, max_seq);
}

void fat_sched_destroy(void* h) { delete static_cast<Scheduler*>(h); }

// Returns 0 on success, -1 if the request can never fit (prompt + generation
// budget exceeds the KV capacity) — rejected immediately rather than queued.
int32_t fat_sched_submit(void* h, int64_t req_id, int32_t prompt_len,
                         int32_t max_new_tokens) {
  auto* s = static_cast<Scheduler*>(h);
  std::lock_guard<std::mutex> lock(s->mu);
  if (prompt_len <= 0 || max_new_tokens <= 0 ||
      prompt_len + max_new_tokens > s->max_seq) {
    s->rejected++;
    return -1;
  }
  s->queue.push_back(
      Request{req_id, prompt_len, max_new_tokens, s->submit_counter++});
  return 0;
}

// Admit queued requests into free slots (FIFO). Writes up to `cap` pairs of
// (req_id, slot). Admitted slots enter kPrefill; the engine must call
// fat_sched_prefill_done(slot) after running the prefill step.
int32_t fat_sched_admit(void* h, int64_t* out_req_ids, int32_t* out_slots,
                        int32_t cap) {
  auto* s = static_cast<Scheduler*>(h);
  std::lock_guard<std::mutex> lock(s->mu);
  int32_t n = 0;
  for (int32_t i = 0; i < s->max_slots && n < cap && !s->queue.empty(); ++i) {
    if (s->slots[i].state != SlotState::kFree) continue;
    Request r = s->queue.front();
    s->queue.pop_front();
    s->slots[i] = Slot{SlotState::kPrefill, r.id, r.prompt_len,
                       r.max_new_tokens, 0};
    out_req_ids[n] = r.id;
    out_slots[n] = i;
    ++n;
  }
  return n;
}

int32_t fat_sched_prefill_done(void* h, int32_t slot) {
  auto* s = static_cast<Scheduler*>(h);
  std::lock_guard<std::mutex> lock(s->mu);
  if (slot < 0 || slot >= s->max_slots ||
      s->slots[slot].state != SlotState::kPrefill)
    return -1;
  s->slots[slot].state = SlotState::kDecode;
  return 0;
}

// List slots currently in the decode state. Returns the count.
int32_t fat_sched_active_slots(void* h, int32_t* out_slots, int32_t cap) {
  auto* s = static_cast<Scheduler*>(h);
  std::lock_guard<std::mutex> lock(s->mu);
  int32_t n = 0;
  for (int32_t i = 0; i < s->max_slots && n < cap; ++i)
    if (s->slots[i].state == SlotState::kDecode) out_slots[n++] = i;
  return n;
}

// Record one generated token for `slot`. Returns 1 if the request finished
// (EOS or token budget exhausted) — the slot is freed and can be re-admitted
// into on the next fat_sched_admit call — else 0. Returns -1 on bad slot.
int32_t fat_sched_record_token(void* h, int32_t slot, int32_t is_eos) {
  auto* s = static_cast<Scheduler*>(h);
  std::lock_guard<std::mutex> lock(s->mu);
  if (slot < 0 || slot >= s->max_slots ||
      s->slots[slot].state != SlotState::kDecode)
    return -1;
  Slot& sl = s->slots[slot];
  sl.generated++;
  if (is_eos || sl.generated >= sl.max_new_tokens) {
    sl = Slot{};  // free
    s->completed++;
    return 1;
  }
  return 0;
}

int64_t fat_sched_slot_request(void* h, int32_t slot) {
  auto* s = static_cast<Scheduler*>(h);
  std::lock_guard<std::mutex> lock(s->mu);
  if (slot < 0 || slot >= s->max_slots) return -1;
  return s->slots[slot].state == SlotState::kFree ? -1 : s->slots[slot].req_id;
}

// stats: [queued, prefilling, decoding, free, completed, rejected]
void fat_sched_stats(void* h, int64_t* out6) {
  auto* s = static_cast<Scheduler*>(h);
  std::lock_guard<std::mutex> lock(s->mu);
  int64_t prefilling = 0, decoding = 0, free_slots = 0;
  for (const auto& sl : s->slots) {
    if (sl.state == SlotState::kFree) free_slots++;
    else if (sl.state == SlotState::kPrefill) prefilling++;
    else decoding++;
  }
  out6[0] = static_cast<int64_t>(s->queue.size());
  out6[1] = prefilling;
  out6[2] = decoding;
  out6[3] = free_slots;
  out6[4] = s->completed;
  out6[5] = s->rejected;
}

}  // extern "C"
