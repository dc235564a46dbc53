"""Block Blast GUI on the PyTorch/CUDA port: counterpart of `gui/app.py`.

A Tkinter app with bbx's four pages, on `bbx_torch`:
  * menu page;
  * human-play page: click-to-select / click-to-place or drag-and-drop with
    a live ghost preview, per-piece colors, score/combo readout, game-over
    overlay (`bbx_torch.env.single.BlockBlastEnv`);
  * training page: `bbx_torch.gui.workers.TrainingRunner` (the port's
    `train` with its progress callback) in a daemon thread, its console
    output in a queue-backed terminal widget, live stat labels, stop via
    the callback;
  * watch page: loads a checkpoint (best/latest/final or any
    checkpoints/checkpoint_*), and `bbx_torch.gui.workers.watch_frames`
    plays it in a worker thread with a speed slider.

The game, the agent and the trainer run on the GUI's device (the CUDA card
unless ``--device cpu``).  Thread -> UI communication uses `queue.Queue`
polled every 50 ms, as bbx's GUI does.  The thread bodies live in
`bbx_torch.gui.workers`, which imports no tkinter.
"""
from __future__ import annotations

import os
import queue
import threading
import time
import tkinter as tk
from tkinter import messagebox, ttk

import numpy as np

from ..engine import pieces as P
from ..render import piece_shape_array
from .workers import OutputRedirector, TrainingRunner, watch_frames

CELL = 48
TRAY_CELL = 22
BOARD_PX = CELL * 8

PIECE_COLORS = [
    "#e74c3c", "#3498db", "#2ecc71", "#f39c12", "#9b59b6",
    "#1abc9c", "#e67e22", "#34495e", "#fd79a8", "#00cec9",
]
BG = "#1e1e2e"
GRID_BG = "#2a2a3c"
GRID_LINE = "#3a3a4e"
FG = "#e8e8f0"
ACCENT = "#89b4fa"


TRAIN_CONFIGS = ["config/default.yaml", "config/run9.yaml", "config/long_train.yaml"]

__all__ = ["BlockBlastGUI", "OutputRedirector", "main"]


class BlockBlastGUI:
    def __init__(self, root: tk.Tk, device="cuda"):
        self.root = root
        self.device = device
        root.title("Block Blast AI — bbx_torch")
        root.configure(bg=BG)
        root.geometry("1000x760")

        self.queue: queue.Queue = queue.Queue()
        self.is_training = False
        self.is_watching = False
        self._watch_thread = None
        self._train_thread = None
        self._runner = None

        # The env is made when the play page first opens.
        self.env = None
        self.selected_slot = None
        self.hover_cell = None

        self.container = tk.Frame(root, bg=BG)
        self.container.pack(fill="both", expand=True)
        self.pages = {}
        self._build_menu_page()
        self._build_play_page()
        self._build_train_page()
        self._build_watch_page()
        self.show_page("menu")
        root.after(50, self._check_queue)

    # ------------------------------------------------------------------ nav
    def show_page(self, name: str):
        for p in self.pages.values():
            p.pack_forget()
        self.pages[name].pack(fill="both", expand=True)

    def _page(self, name: str) -> tk.Frame:
        f = tk.Frame(self.container, bg=BG)
        self.pages[name] = f
        return f

    def _title(self, parent, text):
        tk.Label(parent, text=text, font=("Helvetica", 22, "bold"),
                 fg=ACCENT, bg=BG).pack(pady=12)

    def _nav_row(self, parent):
        row = tk.Frame(parent, bg=BG)
        row.pack(side="bottom", pady=10)
        tk.Button(row, text="← Menu", command=lambda: self.show_page("menu"),
                  bg=GRID_BG, fg=FG).pack()
        return row

    # ----------------------------------------------------------------- menu
    def _build_menu_page(self):
        f = self._page("menu")
        self._title(f, "BLOCK BLAST AI")
        tk.Label(f, text=f"PyTorch/CUDA port (bbx_torch) on {self.device}",
                 fg=FG, bg=BG).pack()
        box = tk.Frame(f, bg=BG)
        box.pack(expand=True)
        for label, page in (("▶  Play", "play"), ("🎓  Train AI", "train"),
                            ("👁  Watch AI", "watch")):
            tk.Button(
                box, text=label, width=24, height=2,
                font=("Helvetica", 14), bg=GRID_BG, fg=FG,
                activebackground=ACCENT,
                command=lambda p=page: self._open_page(p),
            ).pack(pady=8)
        tk.Button(box, text="Quit", width=24, bg=GRID_BG, fg=FG,
                  command=self.root.destroy).pack(pady=18)

    def _open_page(self, page):
        self.show_page(page)
        if page == "play":
            self._new_game()
        elif page == "watch":
            self._refresh_checkpoints()

    # ----------------------------------------------------------------- play
    def _build_play_page(self):
        f = self._page("play")
        self._title(f, "Play")
        top = tk.Frame(f, bg=BG)
        top.pack()
        self.play_status = tk.Label(top, text="", font=("Helvetica", 14),
                                    fg=FG, bg=BG)
        self.play_status.pack()

        mid = tk.Frame(f, bg=BG)
        mid.pack(pady=8)
        self.board_canvas = tk.Canvas(
            mid, width=BOARD_PX, height=BOARD_PX, bg=GRID_BG,
            highlightthickness=0,
        )
        self.board_canvas.grid(row=0, column=0, padx=12)
        self.board_canvas.bind("<Button-1>", self._on_board_click)
        self.board_canvas.bind("<Motion>", self._on_board_motion)
        self.board_canvas.bind("<Leave>", lambda e: self._set_hover(None))

        tray = tk.Frame(mid, bg=BG)
        tray.grid(row=0, column=1, padx=12, sticky="n")
        tk.Label(tray, text="Pieces", fg=FG, bg=BG,
                 font=("Helvetica", 12, "bold")).pack()
        # Tray pieces support both interactions of bbx's GUI: drag-and-drop
        # with a floating semi-transparent piece window, and
        # click-to-select with a hover ghost on the board.
        self.tray_canvases = []
        self._drag = None
        self._drag_win = None
        for i in range(3):
            c = tk.Canvas(tray, width=TRAY_CELL * 5 + 8,
                          height=TRAY_CELL * 5 + 8, bg=GRID_BG,
                          highlightthickness=2, highlightbackground=GRID_LINE)
            c.pack(pady=6)
            c.bind("<Button-1>", lambda e, slot=i: self._start_drag(e, slot))
            c.bind("<B1-Motion>", lambda e, slot=i: self._drag_motion(e))
            c.bind("<ButtonRelease-1>",
                   lambda e, slot=i: self._end_drag(e, slot))
            self.tray_canvases.append(c)

        btns = tk.Frame(f, bg=BG)
        btns.pack(pady=6)
        tk.Button(btns, text="New Game", command=self._new_game,
                  bg=GRID_BG, fg=FG).pack(side="left", padx=6)
        self._nav_row(f)

    def _new_game(self):
        if self.env is None:
            from ..env.single import BlockBlastEnv
            self.env = BlockBlastEnv(seed=int(time.time()) % 100000, device=self.device)
        self.env.reset()
        self.selected_slot = None
        self.hover_cell = None
        self._draw_play()

    def _env_arrays(self):
        s = self.env.state
        return (s.board[0].cpu().numpy(),
                [int(x) for x in s.piece_ids[0].tolist()],
                [bool(x) for x in s.used[0].tolist()])

    def _env_done(self) -> bool:
        return bool(self.env.state.done[0])

    def _select_slot(self, slot):
        _, _, used = self._env_arrays()
        if used[slot] or self._env_done():
            return
        self.selected_slot = None if self.selected_slot == slot else slot
        self._draw_play()

    def _set_hover(self, cell):
        if cell != self.hover_cell:
            self.hover_cell = cell
            self._draw_play()

    def _on_board_motion(self, event):
        r, c = int(event.y // CELL), int(event.x // CELL)
        if 0 <= r < 8 and 0 <= c < 8:
            self._set_hover((r, c))
        else:
            self._set_hover(None)

    def _on_board_click(self, event):
        if self.selected_slot is None or self.env is None:
            return
        r, c = int(event.y // CELL), int(event.x // CELL)
        if not (0 <= r < 8 and 0 <= c < 8):
            return
        self._try_place(self.selected_slot, r, c)

    # ---- drag-and-drop ---------------------------------------------------
    def _start_drag(self, event, slot):
        if self.env is None:
            return
        _, ids, used = self._env_arrays()
        if used[slot] or self._env_done():
            return
        self._drag = {"slot": slot, "moved": False}
        pid = ids[slot]
        arr = piece_shape_array(pid)
        color = PIECE_COLORS[pid % len(PIECE_COLORS)]
        win = tk.Toplevel(self.root)
        win.overrideredirect(True)
        try:
            win.attributes("-alpha", 0.75)
        except tk.TclError:
            pass
        w = arr.shape[1] * TRAY_CELL
        h = arr.shape[0] * TRAY_CELL
        cv = tk.Canvas(win, width=w, height=h, bg=GRID_BG,
                       highlightthickness=0)
        cv.pack()
        for r in range(arr.shape[0]):
            for c in range(arr.shape[1]):
                if arr[r, c]:
                    self._draw_cell(cv, c * TRAY_CELL, r * TRAY_CELL,
                                    TRAY_CELL - 2, color)
        self._drag_win = win
        self._drag_move_window()

    def _drag_move_window(self):
        if self._drag_win is None:
            return
        x = self.root.winfo_pointerx() - TRAY_CELL
        y = self.root.winfo_pointery() - TRAY_CELL
        self._drag_win.geometry(f"+{x}+{y}")

    def _pointer_board_cell(self):
        """Board (row, col) under the mouse pointer, or None."""
        bx = self.root.winfo_pointerx() - self.board_canvas.winfo_rootx()
        by = self.root.winfo_pointery() - self.board_canvas.winfo_rooty()
        r, c = int(by // CELL), int(bx // CELL)
        if 0 <= r < 8 and 0 <= c < 8 and bx >= 0 and by >= 0:
            return r, c
        return None

    def _drag_motion(self, event):
        if self._drag is None:
            return
        self._drag["moved"] = True
        self.selected_slot = self._drag["slot"]
        self._drag_move_window()
        self._set_hover(self._pointer_board_cell())

    def _end_drag(self, event, slot):
        if self._drag is None:
            return
        drag, self._drag = self._drag, None
        if self._drag_win is not None:
            self._drag_win.destroy()
            self._drag_win = None
        cell = self._pointer_board_cell()
        if drag["moved"] and cell is not None:
            self.selected_slot = drag["slot"]
            self._try_place(drag["slot"], *cell)
        elif not drag["moved"]:
            # A press-and-release on the tray is the click-to-select path.
            self._select_slot(slot)
        else:
            self._set_hover(None)

    def _try_place(self, slot, r, c):
        """Execute a placement; flash cleared lines, red-flash invalid."""
        board_before, ids, _ = self._env_arrays()
        obs, reward, done, _, info = self.env.step(slot * 64 + r * 8 + c)
        if info.get("invalid_action"):
            self.board_canvas.configure(highlightbackground="#e74c3c")
            self.root.after(
                150, lambda: self.board_canvas.configure(
                    highlightbackground=GRID_LINE))
            self._draw_play(game_over=done)
            return
        self.selected_slot = None
        self.hover_cell = None
        lm = info.get("last_move") or {}
        self._draw_play(game_over=done)
        if lm.get("lines_cleared"):
            board_after, _, _ = self._env_arrays()
            placed = {(r + dr, c + dc) for dr, dc in P.PIECE_OFFSETS[ids[slot]]}
            flash = [
                (rr, cc) for rr in range(8) for cc in range(8)
                if not board_after[rr, cc]
                and (board_before[rr, cc] or (rr, cc) in placed)
            ]
            for rr, cc in flash:
                self.board_canvas.create_rectangle(
                    cc * CELL + 1, rr * CELL + 1,
                    (cc + 1) * CELL - 1, (rr + 1) * CELL - 1,
                    fill="#ffffff", stipple="gray75", outline="",
                    tags="flash",
                )
            self.root.after(
                140, lambda: self._draw_play(game_over=done))

    def _draw_cell(self, canvas, x, y, size, color):
        """3D-shaded block (the reference's beveled cells)."""
        canvas.create_rectangle(x, y, x + size, y + size, fill=color,
                                outline="")
        canvas.create_polygon(x, y, x + size, y, x + size - 3, y + 3,
                              x + 3, y + 3, fill="#ffffff", stipple="gray50",
                              outline="")
        canvas.create_polygon(x, y + size, x + size, y + size,
                              x + size - 3, y + size - 3, x + 3, y + size - 3,
                              fill="#000000", stipple="gray50", outline="")

    def _draw_play(self, game_over=False):
        if self.env is None:
            return
        board, ids, used = self._env_arrays()
        cv = self.board_canvas
        cv.delete("all")
        for r in range(8):
            for c in range(8):
                x, y = c * CELL, r * CELL
                cv.create_rectangle(x, y, x + CELL, y + CELL,
                                    fill=GRID_BG, outline=GRID_LINE)
                if board[r, c]:
                    self._draw_cell(cv, x + 1, y + 1, CELL - 2, "#7f8fa6")

        # Ghost preview of the selected piece at the hovered anchor.
        if self.selected_slot is not None and self.hover_cell is not None:
            pid = ids[self.selected_slot]
            hr, hc = self.hover_cell
            ok = True
            cells = []
            for dr, dc in P.PIECE_OFFSETS[pid]:
                r, c = hr + dr, hc + dc
                if not (0 <= r < 8 and 0 <= c < 8) or board[r, c]:
                    ok = False
                if 0 <= r < 8 and 0 <= c < 8:
                    cells.append((r, c))
            color = PIECE_COLORS[pid % len(PIECE_COLORS)] if ok else "#e74c3c"
            for r, c in cells:
                cv.create_rectangle(c * CELL + 4, r * CELL + 4,
                                    (c + 1) * CELL - 4, (r + 1) * CELL - 4,
                                    fill=color, stipple="gray50", outline=color)

        info = self.env._get_info()
        self.play_status.configure(
            text=f"Score {info['score']}   Moves {info['moves']}   "
                 f"Lines {info['lines_cleared']}   "
                 f"Max combo {info['max_combo']}")

        for i, c in enumerate(self.tray_canvases):
            c.delete("all")
            c.configure(highlightbackground=(
                ACCENT if self.selected_slot == i else GRID_LINE))
            if used[i]:
                continue
            pid = ids[i]
            color = PIECE_COLORS[pid % len(PIECE_COLORS)]
            arr = piece_shape_array(pid)
            oy = (5 - arr.shape[0]) * TRAY_CELL / 2 + 4
            ox = (5 - arr.shape[1]) * TRAY_CELL / 2 + 4
            for r in range(arr.shape[0]):
                for cc in range(arr.shape[1]):
                    if arr[r, cc]:
                        self._draw_cell(c, ox + cc * TRAY_CELL,
                                        oy + r * TRAY_CELL,
                                        TRAY_CELL - 2, color)

        if game_over or self._env_done():
            cv.create_rectangle(0, BOARD_PX / 2 - 40, BOARD_PX,
                                BOARD_PX / 2 + 40, fill="#000000",
                                stipple="gray75", outline="")
            cv.create_text(BOARD_PX / 2, BOARD_PX / 2,
                           text=f"GAME OVER — {info['score']} pts",
                           fill="#ffffff", font=("Helvetica", 20, "bold"))

    # ---------------------------------------------------------------- train
    def _build_train_page(self):
        f = self._page("train")
        self._title(f, "Train AI")

        cfg_row = tk.Frame(f, bg=BG)
        cfg_row.pack()
        tk.Label(cfg_row, text="Config:", fg=FG, bg=BG).pack(side="left")
        self.train_config_var = tk.StringVar(value="config/default.yaml")
        ttk.Combobox(cfg_row, textvariable=self.train_config_var, width=32,
                     values=TRAIN_CONFIGS).pack(side="left", padx=6)
        self.train_btn = tk.Button(cfg_row, text="Start Training",
                                   command=self._toggle_training,
                                   bg=GRID_BG, fg=FG)
        self.train_btn.pack(side="left", padx=10)

        stats = tk.Frame(f, bg=BG)
        stats.pack(pady=6)
        self.train_labels = {}
        for i, key in enumerate(("step", "fps", "avg_score", "max_score",
                                 "entropy", "approx_kl")):
            tk.Label(stats, text=key, fg=ACCENT, bg=BG).grid(row=0, column=i,
                                                             padx=10)
            lbl = tk.Label(stats, text="—", fg=FG, bg=BG,
                           font=("Courier", 12, "bold"))
            lbl.grid(row=1, column=i, padx=10)
            self.train_labels[key] = lbl

        self.terminal = tk.Text(f, height=22, bg="#11111b", fg="#a6e3a1",
                                font=("Courier", 9), state="disabled")
        self.terminal.pack(fill="both", expand=True, padx=16, pady=8)
        self._nav_row(f)

    def _toggle_training(self):
        if self.is_training:
            # The runner's callback returns False at the next log row, and
            # the trainer saves `final` and returns.
            self.is_training = False
            self._runner.stop()
            self.train_btn.configure(text="Start Training")
            return
        from ..utils.config import load_config

        try:
            config = load_config(self.train_config_var.get())
        except Exception as e:  # a missing or malformed config, shown
            messagebox.showerror("bbx_torch", f"config: {e!r}")
            return
        self.is_training = True
        self.train_btn.configure(text="Stop Training")
        self._runner = TrainingRunner(config, self.queue, device=self.device)
        self._train_thread = threading.Thread(target=self._training_loop,
                                              daemon=True)
        self._train_thread.start()

    def _training_loop(self):
        try:
            self._runner.run()
        finally:
            self.is_training = False

    # ---------------------------------------------------------------- watch
    def _build_watch_page(self):
        f = self._page("watch")
        self._title(f, "Watch AI")

        row = tk.Frame(f, bg=BG)
        row.pack()
        tk.Label(row, text="Checkpoint:", fg=FG, bg=BG).pack(side="left")
        self.watch_ckpt_var = tk.StringVar()
        self.watch_ckpt_box = ttk.Combobox(row,
                                           textvariable=self.watch_ckpt_var,
                                           width=40)
        self.watch_ckpt_box.pack(side="left", padx=6)
        self.watch_btn = tk.Button(row, text="Start", bg=GRID_BG, fg=FG,
                                   command=self._toggle_watch)
        self.watch_btn.pack(side="left", padx=8)

        tk.Label(row, text="Delay (ms):", fg=FG, bg=BG).pack(side="left",
                                                             padx=(16, 2))
        self.watch_delay = tk.Scale(row, from_=50, to=1000, orient="horizontal",
                                    bg=BG, fg=FG, highlightthickness=0)
        self.watch_delay.set(300)
        self.watch_delay.pack(side="left")

        self.watch_status = tk.Label(f, text="", fg=FG, bg=BG,
                                     font=("Helvetica", 13))
        self.watch_status.pack(pady=4)
        self.watch_canvas = tk.Canvas(f, width=BOARD_PX, height=BOARD_PX,
                                      bg=GRID_BG, highlightthickness=0)
        self.watch_canvas.pack(pady=6)
        self._nav_row(f)

    def _refresh_checkpoints(self):
        # The port's checkpoints are files, each with a .config.json sidecar.
        options = []
        for name in ("best", "latest", "final"):
            p = os.path.join("checkpoints", name)
            if os.path.isfile(p):
                options.append(p)
        if os.path.isdir("checkpoints"):
            for entry in sorted(os.listdir("checkpoints")):
                if entry.startswith("checkpoint_") and not entry.endswith(".json"):
                    options.append(os.path.join("checkpoints", entry))
        self.watch_ckpt_box.configure(values=options)
        if options and not self.watch_ckpt_var.get():
            self.watch_ckpt_var.set(options[0])

    def _toggle_watch(self):
        if self.is_watching:
            self.is_watching = False
            self.watch_btn.configure(text="Start")
            return
        ckpt = self.watch_ckpt_var.get()
        if not ckpt or not os.path.isfile(ckpt):
            messagebox.showerror("Watch", "select a valid checkpoint")
            return
        self.is_watching = True
        self.watch_btn.configure(text="Stop")
        self._watch_thread = threading.Thread(
            target=self._watch_loop, args=(ckpt,), daemon=True)
        self._watch_thread.start()

    def _watch_loop(self, ckpt):
        try:
            from ..agent.policy_agent import PolicyAgent

            agent = PolicyAgent.from_checkpoint(ckpt, device=self.device)
            game = 0
            while self.is_watching:
                game += 1
                seed = int(time.time()) % 100000 + game
                for frame in watch_frames(agent, seed, game, device=self.device):
                    if not self.is_watching:
                        break
                    self.queue.put(("watch_update", frame))
                    time.sleep(self.watch_delay.get() / 1000.0)
            self.queue.put(("watch_done", None))
        except Exception as e:
            self.queue.put(("error", f"watch failed: {e!r}"))
            self.is_watching = False

    def _draw_watch(self, payload):
        cv = self.watch_canvas
        cv.delete("all")
        board = payload["board"]
        for r in range(8):
            for c in range(8):
                x, y = c * CELL, r * CELL
                cv.create_rectangle(x, y, x + CELL, y + CELL, fill=GRID_BG,
                                    outline=GRID_LINE)
                if board[r, c]:
                    self._draw_cell(cv, x + 1, y + 1, CELL - 2, "#74b9ff")
        self.watch_status.configure(
            text=f"game {payload['game']}   score {payload['score']}   "
                 f"moves {payload['moves']}   lines {payload['lines']}")

    # ---------------------------------------------------------------- queue
    def _check_queue(self):
        try:
            while True:
                tag, payload = self.queue.get_nowait()
                if tag == "train_log":
                    self.terminal.configure(state="normal")
                    self.terminal.insert("end", payload)
                    self.terminal.see("end")
                    self.terminal.configure(state="disabled")
                elif tag == "training_update":
                    for k, lbl in self.train_labels.items():
                        v = payload.get(k)
                        if v is not None:
                            lbl.configure(
                                text=f"{v:,.2f}" if isinstance(v, float)
                                else f"{v:,}")
                elif tag == "training_done":
                    self.is_training = False
                    self.train_btn.configure(text="Start Training")
                elif tag == "watch_update":
                    self._draw_watch(payload)
                elif tag == "watch_done":
                    self.watch_btn.configure(text="Start")
                elif tag == "error":
                    messagebox.showerror("bbx_torch", payload)
        except queue.Empty:
            pass
        self.root.after(50, self._check_queue)


def main(device="cuda") -> int:
    root = tk.Tk()
    BlockBlastGUI(root, device=device)
    root.mainloop()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
