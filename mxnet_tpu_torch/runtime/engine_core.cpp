// Native host runtime: dependency engine + pooled storage manager.
//
// TPU-native counterpart of the reference's src/engine/ (ThreadedEngine:
// vars with read/write hazard queues, per-device worker pools, profiler
// hooks) and src/storage/ (size-bucketed pooled allocators). On TPU the
// *device* ordering problem is XLA's job, so this engine schedules the HOST
// side: input-pipeline stages, staging-buffer fills, python callbacks,
// checkpoint writes — anything that must overlap with device compute while
// respecting buffer read/write hazards.
//
// Dependency protocol (mirrors threaded_engine.h ThreadedVar semantics,
// redesigned around a per-var FIFO):
//   * every op lists const (read) vars and mutate (write) vars;
//   * per var, queued entries run in push order: consecutive reads may run
//     concurrently, a write runs alone;
//   * an op becomes ready when every var entry it owns is runnable; ready
//     ops go to a priority queue served by a worker pool.
//
// Exposed as a plain C ABI for ctypes (no pybind11 in this image).
#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <deque>
#include <functional>
#include <mutex>
#include <queue>
#include <string>
#include <thread>
#include <unordered_map>
#include <vector>

#include <sys/time.h>

namespace {

using Callback = void (*)(int64_t ctx);

int64_t NowMicros() {
  struct timeval tv;
  gettimeofday(&tv, nullptr);
  return static_cast<int64_t>(tv.tv_sec) * 1000000 + tv.tv_usec;
}

struct Op;

struct VarEntry {
  Op* op;
  bool is_write;
};

struct Var {
  std::deque<VarEntry> q;
  int running_reads = 0;
  bool running_write = false;
  bool to_delete = false;  // deferred deletion (Engine::DeleteVariable)
};

struct ProfRecord {
  std::string name;
  int64_t start_us, end_us;
  uint32_t tid;
};

struct Op {
  Callback fn = nullptr;          // python trampoline (or null)
  std::function<void()> native;   // native closure (wait signalling)
  int64_t ctx = 0;
  std::vector<int64_t> const_vars, mutate_vars;
  std::atomic<int> wait{0};
  int priority = 0;
  int64_t seq = 0;
  std::string name;
};

struct OpCompare {
  bool operator()(Op* a, Op* b) const {
    if (a->priority != b->priority) return a->priority < b->priority;
    return a->seq > b->seq;  // FIFO within priority
  }
};

struct Engine {
  std::mutex mu;
  std::condition_variable ready_cv;   // workers wait here
  std::condition_variable idle_cv;    // wait_all waits here
  std::unordered_map<int64_t, Var> vars;
  std::priority_queue<Op*, std::vector<Op*>, OpCompare> ready;
  std::vector<std::thread> workers;
  int64_t next_var = 1;
  int64_t next_seq = 1;
  int64_t pending = 0;                // pushed, not yet completed
  bool stopping = false;
  std::atomic<bool> profiling{false};
  std::vector<ProfRecord> prof;
  std::atomic<uint32_t> next_tid{0};

  explicit Engine(int num_workers) {
    for (int i = 0; i < num_workers; ++i) {
      workers.emplace_back([this] { WorkerLoop(); });
    }
  }

  ~Engine() { Stop(); }

  void Stop() {
    {
      std::lock_guard<std::mutex> lk(mu);
      if (stopping) return;
      stopping = true;
    }
    ready_cv.notify_all();
    for (auto& t : workers) t.join();
    workers.clear();
  }

  // ---- var queue state machine (caller holds mu) -------------------------
  // Pop every entry at the head of v's queue that may start now; each pop
  // decrements the owning op's wait count, scheduling it at zero.
  void Schedule(int64_t vid, std::vector<Op*>* runnable) {
    Var& v = vars[vid];
    while (!v.q.empty()) {
      VarEntry e = v.q.front();
      if (e.is_write) {
        if (v.running_reads == 0 && !v.running_write) {
          v.running_write = true;
          v.q.pop_front();
          if (e.op->wait.fetch_sub(1) == 1) runnable->push_back(e.op);
        }
        break;  // a write blocks everything behind it
      }
      if (v.running_write) break;
      v.running_reads++;
      v.q.pop_front();
      if (e.op->wait.fetch_sub(1) == 1) runnable->push_back(e.op);
    }
  }

  // Erase a var whose deletion was requested once it fully drains
  // (caller holds mu).
  void MaybeErase(int64_t vid) {
    auto it = vars.find(vid);
    if (it != vars.end() && it->second.to_delete && it->second.q.empty() &&
        it->second.running_reads == 0 && !it->second.running_write) {
      vars.erase(it);
    }
  }

  void MakeReady(const std::vector<Op*>& runnable) {
    for (Op* op : runnable) ready.push(op);
    if (!runnable.empty()) ready_cv.notify_all();
  }

  void Push(Op* op) {
    std::vector<Op*> runnable;
    {
      std::lock_guard<std::mutex> lk(mu);
      pending++;
      op->seq = next_seq++;
      // +1 sentinel so the op can't fire while we're still queueing entries
      op->wait.store(static_cast<int>(op->const_vars.size() +
                                      op->mutate_vars.size()) + 1);
      for (int64_t vid : op->const_vars) {
        vars[vid].q.push_back({op, false});
        Schedule(vid, &runnable);
      }
      for (int64_t vid : op->mutate_vars) {
        vars[vid].q.push_back({op, true});
        Schedule(vid, &runnable);
      }
      if (op->wait.fetch_sub(1) == 1) runnable.push_back(op);
      MakeReady(runnable);
    }
  }

  void Execute(Op* op, uint32_t tid) {
    int64_t t0 = profiling ? NowMicros() : 0;
    if (op->fn) op->fn(op->ctx);
    if (op->native) op->native();
    int64_t t1 = profiling ? NowMicros() : 0;
    std::vector<Op*> runnable;
    {
      std::lock_guard<std::mutex> lk(mu);
      if (profiling) prof.push_back({op->name, t0, t1, tid});
      for (int64_t vid : op->const_vars) {
        Var& v = vars[vid];
        v.running_reads--;
        Schedule(vid, &runnable);
        MaybeErase(vid);
      }
      for (int64_t vid : op->mutate_vars) {
        Var& v = vars[vid];
        v.running_write = false;
        Schedule(vid, &runnable);
        MaybeErase(vid);
      }
      MakeReady(runnable);
      pending--;
      if (pending == 0) idle_cv.notify_all();
    }
    delete op;
  }

  void WorkerLoop() {
    uint32_t tid = next_tid.fetch_add(1);
    while (true) {
      Op* op = nullptr;
      {
        std::unique_lock<std::mutex> lk(mu);
        ready_cv.wait(lk, [this] { return stopping || !ready.empty(); });
        if (stopping && ready.empty()) return;
        op = ready.top();
        ready.pop();
      }
      Execute(op, tid);
    }
  }

  // Synchronous path (0 workers => NaiveEngine semantics): deps are already
  // satisfied in push order because everything runs inline. Var lists are
  // dropped — these ops never entered the hazard queues, so completion
  // bookkeeping on them would corrupt the per-var counters.
  void RunSync(Op* op) {
    {
      std::unique_lock<std::mutex> lk(mu);
      pending++;
    }
    op->const_vars.clear();
    op->mutate_vars.clear();
    op->wait.store(0);
    Execute(op, 0);
  }

  void WaitForVar(int64_t vid) {
    // an internal read op on vid that signals a cv orders us after every
    // previously-pushed op touching vid (engine.h WaitForVar contract)
    std::mutex m;
    std::condition_variable cv;
    bool done = false;
    Op* op = new Op();
    op->const_vars.push_back(vid);
    op->priority = 1 << 20;  // expedite sync points
    op->name = "_wait_for_var";
    op->native = [&] {
      std::lock_guard<std::mutex> lk(m);
      done = true;
      cv.notify_all();
    };
    if (workers.empty()) {
      RunSync(op);
      return;
    }
    Push(op);
    std::unique_lock<std::mutex> lk(m);
    cv.wait(lk, [&] { return done; });
  }

  void WaitAll() {
    std::unique_lock<std::mutex> lk(mu);
    idle_cv.wait(lk, [this] { return pending == 0; });
  }
};

// ---------------------------------------------------------------- storage
// Size-bucketed pooled host allocator (pooled_storage_manager.h redesigned
// for host staging buffers: 64-byte aligned for fast H2D DMA staging).
struct Pool {
  std::mutex mu;
  std::unordered_map<size_t, std::vector<void*>> free_list;
  std::unordered_map<void*, size_t> sizes;
  size_t used_bytes = 0;   // handed out
  size_t pooled_bytes = 0; // cached in free lists

  static size_t Bucket(size_t n) {
    size_t b = 64;
    while (b < n) b <<= 1;
    return b;
  }

  void* Alloc(size_t n) {
    size_t b = Bucket(n);
    {
      std::lock_guard<std::mutex> lk(mu);
      auto it = free_list.find(b);
      if (it != free_list.end() && !it->second.empty()) {
        void* p = it->second.back();
        it->second.pop_back();
        pooled_bytes -= b;
        used_bytes += b;
        return p;
      }
    }
    void* p = nullptr;
    if (posix_memalign(&p, 64, b) != 0) return nullptr;
    std::lock_guard<std::mutex> lk(mu);
    sizes[p] = b;
    used_bytes += b;
    return p;
  }

  void Free(void* p) {
    std::lock_guard<std::mutex> lk(mu);
    auto it = sizes.find(p);
    if (it == sizes.end()) return;
    free_list[it->second].push_back(p);
    used_bytes -= it->second;
    pooled_bytes += it->second;
  }

  void DirectFree(void* p) {
    std::lock_guard<std::mutex> lk(mu);
    auto it = sizes.find(p);
    if (it == sizes.end()) return;
    used_bytes -= it->second;
    sizes.erase(it);
    free(p);
  }

  void ReleaseAll() {
    std::lock_guard<std::mutex> lk(mu);
    for (auto& kv : free_list) {
      for (void* p : kv.second) {
        pooled_bytes -= sizes[p];
        sizes.erase(p);
        free(p);
      }
      kv.second.clear();
    }
  }
};

}  // namespace

extern "C" {

// ------------------------------------------------------------------ engine
void* eng_create(int num_workers) { return new Engine(num_workers); }

void eng_destroy(void* h) { delete static_cast<Engine*>(h); }

int64_t eng_new_var(void* h) {
  Engine* e = static_cast<Engine*>(h);
  std::lock_guard<std::mutex> lk(e->mu);
  int64_t v = e->next_var++;
  e->vars[v];  // default-construct
  return v;
}

void eng_del_var(void* h, int64_t vid) {
  Engine* e = static_cast<Engine*>(h);
  std::lock_guard<std::mutex> lk(e->mu);
  auto it = e->vars.find(vid);
  if (it == e->vars.end()) return;
  if (it->second.q.empty() && it->second.running_reads == 0 &&
      !it->second.running_write) {
    e->vars.erase(it);
  } else {
    // busy: defer — erased by MaybeErase when the last op drains
    // (Engine::DeleteVariable contract, include/mxnet/engine.h)
    it->second.to_delete = true;
  }
}

// fn(ctx) runs when all hazards clear. const_vars/mutate_vars are arrays of
// var ids. Duplicate or overlapping var lists are the caller's error (the
// python layer deduplicates, mirroring DeduplicateVarHandle).
void eng_push(void* h, Callback fn, int64_t ctx, const int64_t* const_vars,
              int n_const, const int64_t* mutate_vars, int n_mut,
              int priority, const char* name) {
  Engine* e = static_cast<Engine*>(h);
  Op* op = new Op();
  op->fn = fn;
  op->ctx = ctx;
  op->const_vars.assign(const_vars, const_vars + n_const);
  op->mutate_vars.assign(mutate_vars, mutate_vars + n_mut);
  op->priority = priority;
  if (name) op->name = name;
  if (e->workers.empty()) {
    e->RunSync(op);
  } else {
    e->Push(op);
  }
}

void eng_wait_for_var(void* h, int64_t vid) {
  static_cast<Engine*>(h)->WaitForVar(vid);
}

void eng_wait_all(void* h) {
  Engine* e = static_cast<Engine*>(h);
  if (e->workers.empty()) return;
  e->WaitAll();
}

int64_t eng_pending(void* h) {
  Engine* e = static_cast<Engine*>(h);
  std::lock_guard<std::mutex> lk(e->mu);
  return e->pending;
}

void eng_profile_start(void* h) {
  static_cast<Engine*>(h)->profiling = true;
}

void eng_profile_stop(void* h) {
  static_cast<Engine*>(h)->profiling = false;
}

// Escape a string for embedding in a JSON double-quoted literal.
static std::string JsonEscape(const std::string& s) {
  std::string out;
  out.reserve(s.size());
  for (unsigned char c : s) {
    switch (c) {
      case '"': out += "\\\""; break;
      case '\\': out += "\\\\"; break;
      case '\n': out += "\\n"; break;
      case '\t': out += "\\t"; break;
      case '\r': out += "\\r"; break;
      default:
        if (c < 0x20) {
          char buf[8];
          snprintf(buf, sizeof(buf), "\\u%04x", c);
          out += buf;
        } else {
          out += static_cast<char>(c);
        }
    }
  }
  return out;
}

// Dump collected records as Chrome trace JSON (profiler.h EmitEvent shape);
// returns number of records written, -1 on IO error.
int64_t eng_profile_dump(void* h, const char* path, int clear) {
  Engine* e = static_cast<Engine*>(h);
  std::vector<ProfRecord> recs;
  {
    std::lock_guard<std::mutex> lk(e->mu);
    recs = e->prof;
    if (clear) e->prof.clear();
  }
  FILE* f = fopen(path, "w");
  if (!f) return -1;
  fprintf(f, "{\n\"traceEvents\": [\n");
  for (size_t i = 0; i < recs.size(); ++i) {
    const ProfRecord& r = recs[i];
    fprintf(f,
            "  {\"name\": \"%s\", \"ph\": \"X\", \"ts\": %lld, "
            "\"dur\": %lld, \"pid\": 0, \"tid\": %u}%s\n",
            JsonEscape(r.name).c_str(), static_cast<long long>(r.start_us),
            static_cast<long long>(r.end_us - r.start_us), r.tid,
            i + 1 < recs.size() ? "," : "");
  }
  fprintf(f, "]\n}\n");
  fclose(f);
  return static_cast<int64_t>(recs.size());
}

// ----------------------------------------------------------------- storage
void* sto_create() { return new Pool(); }
void sto_destroy(void* h) {
  Pool* p = static_cast<Pool*>(h);
  p->ReleaseAll();
  delete p;
}
void* sto_alloc(void* h, int64_t nbytes) {
  return static_cast<Pool*>(h)->Alloc(static_cast<size_t>(nbytes));
}
void sto_free(void* h, void* ptr) { static_cast<Pool*>(h)->Free(ptr); }
void sto_direct_free(void* h, void* ptr) {
  static_cast<Pool*>(h)->DirectFree(ptr);
}
void sto_release_all(void* h) { static_cast<Pool*>(h)->ReleaseAll(); }
int64_t sto_used_bytes(void* h) {
  return static_cast<int64_t>(static_cast<Pool*>(h)->used_bytes);
}
int64_t sto_pooled_bytes(void* h) {
  return static_cast<int64_t>(static_cast<Pool*>(h)->pooled_bytes);
}

}  // extern "C"
